"""Engine selection without silent fallbacks: an explicitly chosen device
engine raises when it fails, the replicated scan map's budget follows the
device allocator's limit, the compile cache sits at a fixed path, and the
native libraries are keyed on their source and flags."""

import os
import types

import jax
import numpy as np
import pytest

from mindthegap_tpu.find import runner
from mindthegap_tpu.graph import dbg
from mindthegap_tpu.ops import extmap as X
from mindthegap_tpu.utils import compile_cache, native_build


def _graph(n_solid: int, k: int = 31):
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 1 << 62, n_solid, dtype=np.uint64))
    return dbg.Graph(dbg.SolidSet(keys, k, np.full(keys.size, 5, np.int64))), dbg.SolidSet(
        np.zeros(0, np.uint64), k - 1
    )


@pytest.mark.parametrize(
    "make, engine",
    [
        (runner._make_pay_feed_fn, "device-qp"),
        (runner._make_pay_feed_fn, "sharded"),
        (runner._make_plane_fn, "device-qp"),
        (runner._make_plane_fn, "sharded"),
    ],
    ids=["feed-device-qp", "feed-sharded", "planes-device-qp", "planes-sharded"],
)
def test_explicit_device_engine_raises_on_failure(monkeypatch, make, engine):
    """A failing map build propagates: no warning-and-host-scan fallback."""

    def boom(*_a, **_k):
        raise RuntimeError("map build failed")

    monkeypatch.setattr(X, "build_fused_pair", boom)
    graph, rep = _graph(1000)
    with pytest.raises(RuntimeError, match="map build failed"):
        make(engine, graph, rep, 31)


def test_sharded_mem_on_one_device_raises(monkeypatch):
    """sharded-mem needs a mesh; on one device it is an error, not host."""
    from mindthegap_tpu.parallel import mesh as M

    real = M.make_mesh
    monkeypatch.setattr(M, "make_mesh", lambda n=None, axis="shard": real(1, axis))
    graph, rep = _graph(1000)
    with pytest.raises(RuntimeError, match="multi-device mesh"):
        runner._make_plane_fn("sharded-mem", graph, rep, 31)


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize(
    "stats, scan_memory_mb, n_solid, over",
    [
        # 40k solid keys project to a 2 MiB map: over a 1 MiB allocator limit
        ({"bytes_limit": 1 << 20}, 0, 40_000, True),
        ({"bytes_limit": 1 << 30}, 0, 40_000, False),
        # no limit reported (the CPU): no gate unless -scan-memory is given
        (None, 0, 40_000, False),
        (None, 1, 40_000, True),
        # -scan-memory wins over the device's limit
        ({"bytes_limit": 1 << 20}, 64, 40_000, False),
    ],
    ids=["over-device-limit", "under-device-limit", "no-limit", "no-limit-scan-memory",
         "scan-memory-overrides"],
)
def test_scan_budget_follows_device_limit(monkeypatch, stats, scan_memory_mb, n_solid, over):
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(stats), _Dev(stats)])
    graph, _rep = _graph(n_solid)
    assert runner._scan_map_bytes_estimate(len(graph.solid)) == 2 << 20
    assert runner._over_budget_mesh(graph, scan_memory_mb) is over
    expect = (scan_memory_mb << 20) if scan_memory_mb else (stats or {}).get("bytes_limit")
    assert runner._scan_budget_bytes(scan_memory_mb) == expect


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout_path(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.CHECKOUT_CACHE
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.dirname(path) == os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert os.path.basename(path) == ".jax_cache"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_build_keyed_on_source_and_flags(monkeypatch, tmp_path):
    """A library is rebuilt when its source or flags change, however new the
    old file's mtime; an unchanged key is loaded, not rebuilt."""
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(tmp_path))
    src = tmp_path / "probe.cpp"
    src.write_text('extern "C" int probe() { return 1; }\n')
    a = native_build.build("probe.cpp")
    assert os.path.exists(a) and os.path.basename(a).startswith("libprobe-")
    os.utime(a, (2**31, 2**31))  # far-future mtime must not pin the old build
    src.write_text('extern "C" int probe() { return 2; }\n')
    b = native_build.build("probe.cpp")
    c = native_build.build("probe.cpp", "-O2")
    assert len({a, b, c}) == 3
    assert native_build.build("probe.cpp") == b
    import ctypes

    assert ctypes.CDLL(b).probe() == 2 and ctypes.CDLL(a).probe() == 1


def test_native_build_failure_is_recorded(monkeypatch, tmp_path):
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(tmp_path))
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native_build.build("broken.cpp")
    assert "broken.cpp" in native_build.errors
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".so")]


def test_fill_device_engine_raises_on_failure(monkeypatch, tmp_path):
    """-fill-engine device: a failing walker propagates out of the runner."""
    from mindthegap_tpu.fill import walk_device
    from mindthegap_tpu.fill.runner import Filler

    class Broken:
        def __init__(self, *a, **k):
            raise RuntimeError("walker failed")

    monkeypatch.setattr(walk_device, "BatchWalker", Broken)
    f = Filler.__new__(Filler)
    f.fill_engine, f.k, f.nb_cores = "device", 31, 1
    f.view = types.SimpleNamespace(qm=object())
    with pytest.raises(RuntimeError, match="walker failed"):
        list(f._run_jobs_local(None, lambda *j: iter(()), [("a", "b")]))


def test_fill_device_mesh_failure_propagates(monkeypatch):
    """-fill-engine device on several devices: a failing mesh build is an
    error, not a silent single-device walker."""
    from mindthegap_tpu.fill import walk_device
    from mindthegap_tpu.fill.runner import Filler
    from mindthegap_tpu.parallel import mesh as M

    assert len(jax.devices()) > 1  # the mesh branch runs

    def boom(*_a, **_k):
        raise RuntimeError("mesh failed")

    built = []
    monkeypatch.setattr(M, "make_mesh", boom)
    monkeypatch.setattr(walk_device, "BatchWalker", lambda *a, **k: built.append(k))
    f = Filler.__new__(Filler)
    f.fill_engine, f.k, f.nb_cores = "device", 31, 1
    f.view = types.SimpleNamespace(qm=object())
    with pytest.raises(RuntimeError, match="mesh failed"):
        list(f._run_jobs_local(None, lambda *j: iter(()), [("a", "b")]))
    assert not built
