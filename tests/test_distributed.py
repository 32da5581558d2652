"""Two-process multi-host parity (SURVEY.md §4): the same find run executed
by two jax.distributed processes sharing one global mesh must produce
artifacts byte-identical to the single-process run."""

import io
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "distributed_find_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_find_parity(tmp_path):
    coordinator = f"127.0.0.1:{_free_port()}"
    outdir = str(tmp_path)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker pins its own device count (4/process)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(pid), outdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"WORKER_OK {pid}" in out
        assert f"COUNT_OK {pid}" in out

    # exactly one writer host, and it is process 0
    assert open(os.path.join(outdir, "writer0")).read() == "1"
    assert open(os.path.join(outdir, "writer1")).read() == "0"

    # single-process oracle
    from mindthegap_tpu.find import runner

    data = "/root/reference/data"
    solo = os.path.join(outdir, "solo")
    runner.run_find(
        {
            "in": f"{data}/reads_r1.fastq,{data}/reads_r2.fastq",
            "ref": f"{data}/reference.fasta",
            "out": solo,
            "scan-engine": "host",
            "automaton": "host",
            "verbose": 0,
        },
        out=io.StringIO(),
    )

    def strip_vcf(path):
        return [l for l in open(path) if not l.startswith("##")]

    for pid in range(2):
        prefix = os.path.join(outdir, f"proc{pid}")
        assert open(prefix + ".breakpoints").read() == open(solo + ".breakpoints").read()
        assert strip_vcf(prefix + ".othervariants.vcf") == strip_vcf(solo + ".othervariants.vcf")

    # 2-process -count-engine sharded graph artifact == solo graph
    import numpy as np

    from mindthegap_tpu.graph import dbg

    gs = dbg.Graph.load(os.path.join(outdir, "proc0") + ".h5")
    gh = dbg.Graph.load(solo + ".h5")
    assert gh.info == gs.info
    assert np.array_equal(gh.solid.keys, gs.solid.keys)
    assert np.array_equal(gh.solid.counts, gs.solid.counts)


@pytest.mark.slow
@pytest.mark.parametrize("fill_engine", ["auto", "device"], ids=["auto", "device"])
def test_two_process_fill_parity(tmp_path, fill_engine):
    """2-process fill -bkpt: jobs sharded by shard_bounds, per-shard results
    allgathered — merged .insertions.fasta/.insertions.vcf byte-identical to
    the solo run (VERDICT r3 item 5a). Parameterized over -fill-engine
    device: each process runs the batched walker on its own job shard
    (VERDICT r4 item 5 — the forced host downgrade is gone)."""
    import io

    outdir = str(tmp_path)

    # solo oracle: find (graph + breakpoints) then fill
    from mindthegap_tpu.fill import runner as fill_runner
    from mindthegap_tpu.find import runner as find_runner

    data = "/root/reference/data"
    solo = os.path.join(outdir, "solo")
    find_runner.run_find(
        {
            "in": f"{data}/reads_r1.fastq,{data}/reads_r2.fastq",
            "ref": f"{data}/reference.fasta",
            "out": solo,
            "scan-engine": "host",
            "automaton": "host",
            "verbose": 0,
        },
        out=io.StringIO(),
    )
    solo_fill = os.path.join(outdir, "solofill")
    fill_runner.run_fill(
        {"graph": solo + ".h5", "bkpt": solo + ".breakpoints", "out": solo_fill, "verbose": 0},
        out=io.StringIO(),
    )

    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    worker = os.path.join(HERE, "distributed_fill_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coordinator, "2", str(pid), outdir,
             solo + ".h5", solo + ".breakpoints", fill_engine],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"fill worker {pid} failed:\n{out[-4000:]}"
        assert f"WORKER_OK {pid}" in out
        assert f"FILL_SHARD_OK {pid}" in out

    assert open(os.path.join(outdir, "fillwriter0")).read() == "1"
    assert open(os.path.join(outdir, "fillwriter1")).read() == "0"

    def strip_vcf(path):
        return [l for l in open(path) if not l.startswith("##")]

    for pid in range(2):
        prefix = os.path.join(outdir, f"fillproc{pid}")
        assert (
            open(prefix + ".insertions.fasta").read()
            == open(solo_fill + ".insertions.fasta").read()
        )
        assert strip_vcf(prefix + ".insertions.vcf") == strip_vcf(solo_fill + ".insertions.vcf")
        assert open(prefix + ".info.txt").read() == open(solo_fill + ".info.txt").read()
