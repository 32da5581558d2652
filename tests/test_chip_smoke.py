"""chip_smoke.py's phases at a tiny size: explicit device engines against
the host oracles on the CPU backend (8 virtual devices), the refusal to run
without a GPU, and the same phases on the card (`gpu` marker)."""

import importlib.util
import io
import os
import re
from contextlib import redirect_stdout

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dep31(cs, tmp_path_factory):
    return cs.make_deployment(str(tmp_path_factory.mktemp("k31")), 1 << 15, 11)


def test_deployment_shape(cs, dep31):
    """Reads at 30x of 150 bp pairs, and every planted variant kind present."""
    assert dep31["n_pairs"] == pytest.approx(30 * (1 << 15) / 300, rel=0.02)
    kinds = sorted(k for k, _p, _s in dep31["planted"])
    assert kinds == ["het", "hom"]
    with open(dep31["reads"].split(",")[0]) as f:
        head = [next(f) for _ in range(2)]
    assert re.fullmatch(r">p\d{10}/1\n", head[0]) and len(head[1]) == 151


def test_find_and_fill_phases_match_oracle(cs, dep31, tmp_path):
    log = []
    graph, bkpt, times = cs.find_vs_oracle(
        dep31, str(tmp_path), 31,
        ["-count-engine", "device", "-scan-engine", "device-qp"], log=log.append,
    )
    assert "artifacts identical to the host oracle" in log[-1]
    assert set(times) == {"find k=31 host oracle",
                          "find k=31 -count-engine device -scan-engine device-qp"}
    times = cs.fill_engines_agree(graph, bkpt, str(tmp_path), 31,
                                  ["device", "native", "host"], log=log.append)
    assert len(times) == 3 and "identical" in log[-1]


def test_k63_phases_match_oracle(cs, tmp_path):
    dep = cs.make_deployment(str(tmp_path / "k63"), 1 << 14, 12)
    graph, bkpt, _t = cs.find_vs_oracle(dep, str(tmp_path), 63, ["-scan-engine", "device"],
                                        reuse_graph=True, log=lambda s: None)
    cs.fill_engines_agree(graph, bkpt, str(tmp_path), 63, ["device", "host"], log=lambda s: None)


def test_find_mismatch_is_an_error(cs, dep31, tmp_path, monkeypatch):
    """A differing artifact fails the phase (the oracle is the reference)."""
    real = cs._same_bytes

    def corrupt_then_compare(a, b, what):
        with open(a, "a") as f:
            f.write(">bkpt_extra\nACGT\n")
        real(a, b, what)

    monkeypatch.setattr(cs, "_same_bytes", corrupt_then_compare)
    with pytest.raises(cs.SmokeFailure, match="breakpoints"):
        cs.find_vs_oracle(dep31, str(tmp_path), 31, ["-scan-engine", "device-qp"],
                          reuse_graph=True, log=lambda s: None)


def test_profile_lines_parse_report(cs):
    report = ("    Time                                     : 1.0 s\n"
              "    Per-phase timings                        \n"
              "        graph build                          : 0.29 s\n"
              "        scan+replay (fused)                  : 4.35 s\n"
              "    Output files                             \n")
    assert cs.profile_lines(report) == ["graph build: 0.29 s", "scan+replay (fused): 4.35 s"]


def test_main_refuses_a_non_gpu_platform(cs, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")  # main pins it; undone after the test
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cs.main([])
    assert rc != 0
    assert '"ok"' not in out.getvalue()


@pytest.mark.gpu
def test_phases_on_gpu(cs, gpu, tmp_path):
    """The tiny deployment through the explicit device engines on the card."""
    dep = cs.make_deployment(str(tmp_path / "k31"), 1 << 15, 13)
    graph, bkpt, _t = cs.find_vs_oracle(dep, str(tmp_path), 31,
                                        ["-count-engine", "device", "-scan-engine", "device-qp"])
    cs.fill_engines_agree(graph, bkpt, str(tmp_path), 31, ["device", "native", "host"])
