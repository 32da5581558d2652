"""Worker for the 2-process multi-host parity test (SURVEY.md §4: "multi-host
tests (2 hosts) asserting identical merged artifacts vs 1-host run").

Each process: jax.distributed.initialize over a localhost coordinator, a
global 1-D mesh spanning both processes' CPU devices, then the REAL find
pipeline with `-scan-engine sharded` — window shards land on both processes'
devices, planes are process_allgather'ed, and the writer host emits the
artifacts. Run by tests/test_distributed.py.

Usage: distributed_find_worker.py <coordinator> <num_procs> <pid> <outdir>
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
    coordinator, num_procs, pid, outdir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )

    import jax

    from mindthegap_tpu.parallel.distributed import global_mesh, init_distributed, is_writer

    init_distributed(coordinator, num_procs, pid)
    assert jax.process_count() == num_procs, jax.process_count()
    mesh = global_mesh()
    assert mesh.devices.size == 4 * num_procs

    from mindthegap_tpu.find import runner

    data = "/root/reference/data"
    prefix = os.path.join(outdir, f"proc{pid}")
    opts = {
        "in": f"{data}/reads_r1.fastq,{data}/reads_r2.fastq",
        "ref": f"{data}/reference.fasta",
        "out": prefix,
        "scan-engine": "sharded",
        "count-engine": "sharded",  # 2-process DSK over the global mesh;
        # the parent asserts the written .h5 equals the solo graph
        "automaton": "host",
        "verbose": 0,
    }
    runner.run_find(opts, out=io.StringIO())
    # every process computed identical artifacts from the gathered planes;
    # the writer-host marker is what a production launcher keys file moves on
    with open(os.path.join(outdir, f"writer{pid}"), "w") as f:
        f.write("1" if is_writer() else "0")

    # multi-host sharded counting: all_to_all key routing + psum histogram
    # over the GLOBAL mesh must match the host counter exactly
    import numpy as np

    from mindthegap_tpu.io.bank import iter_codes
    from mindthegap_tpu.ops.counting import StreamingCounter
    from mindthegap_tpu.parallel.sharded_count import ShardedStreamingCounter

    host = StreamingCounter(21)
    sharded = ShardedStreamingCounter(21, mesh=mesh, batch_bases=1 << 13)
    n = 0
    for _h, codes in iter_codes(f"{data}/reads_r1.fastq"):
        host.add_codes(codes)
        sharded.add_codes(codes)
        n += 1
        if n >= 120:
            break
    hr, sr = host.result(), sharded.result()
    assert np.array_equal(hr.kmers, sr.kmers)
    assert np.array_equal(hr.counts, sr.counts)
    assert np.array_equal(hr.histogram, sr.histogram)
    print("COUNT_OK", pid)
    print("WORKER_OK", pid)


if __name__ == "__main__":
    main()
