"""Worker for the 2-process fill parity test (SURVEY.md §4 / VERDICT r3
item 5): each process runs the REAL fill pipeline with breakpoint jobs
sharded by shard_bounds across processes, per-shard results allgathered and
replayed in input order — artifacts must be byte-identical to the solo run.

Usage: distributed_fill_worker.py <coordinator> <num_procs> <pid> <outdir> <graph_h5> <bkpt>
"""

import io
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    coordinator, num_procs, pid, outdir, graph_h5, bkpt = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6]
    )
    fill_engine = sys.argv[7] if len(sys.argv) > 7 else "auto"

    import jax

    from mindthegap_tpu.parallel.distributed import init_distributed, is_writer

    init_distributed(coordinator, num_procs, pid)
    assert jax.process_count() == num_procs, jax.process_count()

    from mindthegap_tpu.fill import runner

    prefix = os.path.join(outdir, f"fillproc{pid}")
    filler = runner.Filler(
        {"graph": graph_h5, "bkpt": bkpt, "out": prefix, "verbose": 0,
         "fill-engine": fill_engine},
        out=io.StringIO(),
    )
    filler.execute()
    # the shard really ran a strict subset of the jobs
    assert 0 < filler.n_local_jobs < filler.nb_breakpoints, (
        filler.n_local_jobs, filler.nb_breakpoints,
    )
    with open(os.path.join(outdir, f"fillwriter{pid}"), "w") as f:
        f.write("1" if is_writer() else "0")
    print("FILL_SHARD_OK", pid, filler.n_local_jobs, "/", filler.nb_breakpoints)
    print("WORKER_OK", pid)


if __name__ == "__main__":
    main()
