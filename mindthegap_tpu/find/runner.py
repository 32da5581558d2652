"""`find` module orchestration (the reference Finder tool, src/Finder.cpp).

Builds or loads the de Bruijn graph, builds the reference-repeat set,
registers the observer cascade according to the mode flags
(src/Finder.cpp:320-398, 543-586), scans every reference sequence and
writes `<out>.breakpoints` + `<out>.othervariants.vcf`.
"""

from __future__ import annotations

import time

import numpy as np

from .. import MTG_COMPAT_VERSION, KSIZE_STRING
from ..graph import dbg
from ..ops import kmers as K
from ..io.bank import Bank
from ..utils import dna
from ..utils.progress import Progress
from ..utils.properties import Properties
from . import scan
from .automaton import ScanContext
from . import observers as O


class FinderError(Exception):
    pass


class _StatsHolder:
    def __init__(self, stats):
        self.stats = stats


def default_output_prefix() -> str:
    return "MindTheGap_Expe-" + time.strftime("%Y-%m-%d.%I:%M")


def _stoi(s: str) -> int:
    """std::stoi semantics: parse the leading integer, ignore the rest."""
    s = s.lstrip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        raise ValueError(f"stoi: no conversion: {s!r}")
    return int(s[:j])


def parse_bed_for_chrom(bed_path: str, chrom_name: str, k: int):
    """Collect this chromosome's intervals, in file order, keeping those
    longer than k (src/FindBreakpoints.hpp:461-490)."""
    intervals = []
    with open(bed_path) as f:
        for line in f:
            line = line.rstrip("\n")
            if len(line) == 0 or line[0] in "#@":
                continue
            v = line.split("\t")
            if v[0] == chrom_name:
                bed_begin, bed_end = _stoi(v[1]), _stoi(v[2])
                if bed_end - bed_begin > k:
                    intervals.append((bed_begin, bed_end))
    return intervals


def _scan_map_bytes_estimate(n_solid: int) -> int:
    """Projected footprint of the replicated pair-coalesced scan map: 16 B
    per slot row, power-of-two sizing at load factor 0.35 (extmap.py QMapP)."""
    import math

    n = max(int(n_solid), 1)
    return (1 << math.ceil(math.log2(n / 0.35))) * 16


_VALID_SCAN_ENGINES = ("auto", "host", "device", "device-qp", "device-qb", "sharded", "sharded-mem")


def _validate_scan_engine(engine: str):
    if engine not in _VALID_SCAN_ENGINES:
        raise FinderError(
            "ERROR: unknown -scan-engine %r (choose from %s)"
            % (engine, ", ".join(_VALID_SCAN_ENGINES))
        )


def _scan_budget_bytes(scan_memory_mb: int) -> int | None:
    """Per-device budget for the replicated scan map: -scan-memory MB when
    given, else the device allocator's own limit; None (no gate) on a
    backend that reports no limit (the CPU)."""
    if scan_memory_mb > 0:
        return scan_memory_mb << 20
    import jax

    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
    return int(limit) if limit else None


def _over_budget_mesh(graph, scan_memory_mb: int) -> bool:
    """True when the replicated k<=32 scan map would exceed the per-device
    budget AND a multi-device mesh exists to reroute membership through
    (the sharded-mem capacity gate, SURVEY.md §2.3 last row)."""
    budget = _scan_budget_bytes(scan_memory_mb)
    if budget is None or _scan_map_bytes_estimate(len(graph.solid)) <= budget:
        return False
    import jax

    return len(jax.devices()) > 1


def _auto_small_or_cpu(graph) -> bool:
    """True when -scan-engine auto should stay on the host plane path: the
    device path pays a table build + XLA compile, only worth it on
    genome-scale runs with an accelerator attached. (The 2^21 solid-key
    switch is not measured on the H100.)"""
    if len(graph.solid) < (1 << 21):
        return True
    import jax

    return jax.default_backend() == "cpu"


def _make_plane_fn(engine: str, graph, repeat_set, k: int, scan_memory_mb: int = 0):
    """Select the scan engine: "host" (numpy oracle), "device" (XLA pass over
    the extension-bitmap map — identical results),
    "sharded" (window-sharded over the mesh, replicated map), "sharded-mem"
    (key-range-sharded membership with Bloom-prefiltered all_to_all routing
    for over-HBM solid sets), or "auto" (device when an accelerator is
    present and the sets fit the k<=32 device path; switches to sharded-mem
    when the replicated map would exceed the per-chip budget and a mesh is
    available)."""
    _validate_scan_engine(engine)

    def host_fn(codes):
        return scan.compute_planes(codes, k, graph.solid.kmers, repeat_set.kmers)

    if engine == "host" or k > 256:
        return host_fn
    if engine == "sharded" and k > 32:
        # span windows over the mesh (packed span map; k <= 32 falls
        # through to the budget gate below first)
        return _make_sharded_plane_fn(graph, repeat_set, k, host_fn)
    if k > 32:
        return _make_span_plane_fn(engine, graph, repeat_set, k, host_fn)
    if engine in ("auto", "sharded") and k <= 32 and _over_budget_mesh(graph, scan_memory_mb):
        engine = "sharded-mem"
    if engine == "sharded-mem":
        return _make_sharded_mem_plane_fn(graph, repeat_set, k, host_fn)
    if engine == "sharded":
        return _make_sharded_plane_fn(graph, repeat_set, k, host_fn)
    if engine == "auto" and _auto_small_or_cpu(graph):
        return host_fn

    import jax.numpy as jnp

    from ..ops import extmap as X
    from .scan_device import (
        scan_planes_device_q,
        scan_planes_device_qb,
        scan_planes_device_qp,
    )
    from .scan import Planes

    if engine == "auto":
        # auto resolves to the pair-coalesced map
        engine = "device-qp"
    if engine == "device-qp":
        # pair-coalesced map: one [1,2]-u64 row lookup per TWO positions
        # (ops/extmap.py QMapP header math)
        qp = X.build_fused_pair(graph.solid.kmers, k, repeat_set.kmers)
        targs = (
            jnp.asarray(qp.slots), jnp.asarray(qp.stash_keys),
            jnp.asarray(qp.stash_l), jnp.asarray(qp.stash_r),
        )
        log_param = qp.log_size
        scan_fn = scan_planes_device_qp
    elif engine == "device-qb":
        # single-probe 16-slot bucket map: 1 gather/position (ops/extmap.py
        # QMapB header math) vs the cuckoo map's 2
        qb = X.build_fused_bucket(graph.solid.kmers, k, repeat_set.kmers)
        targs = (
            jnp.asarray(qb.slots), jnp.asarray(qb.stash_keys),
            jnp.asarray(qb.stash_payload),
        )
        log_param = qb.log_nb
        scan_fn = scan_planes_device_qb
    else:
        qm = X.build_fused(graph.solid.kmers, k, repeat_set.kmers)
        targs = (
            jnp.asarray(qm.slots), jnp.asarray(qm.stash_keys),
            jnp.asarray(qm.stash_payload),
        )
        log_param = qm.log_size
        scan_fn = scan_planes_device_q

    window = 1 << 22
    group = 8  # windows vmapped into one dispatch (not measured on the H100)
    halo = k - 1

    import jax

    packed = engine == "device-qp"
    if packed:
        from .scan_device import planes_from_pay, scan_pay_device_qp

        @jax.jit
        def scan_group(rows, *tables):
            # packed path: only the 2-byte payload stream leaves the
            # device (~10x less device->host transfer than the plane
            # tuple); fwd/valid and the plane math run on host
            # (native extract + ~10 numpy ops), overlapped with the
            # next group's device compute
            return jax.vmap(lambda row: scan_pay_device_qp(row, *tables, log_param, k))(rows)
    else:
        @jax.jit
        def scan_group(rows, *tables):
            return jax.vmap(lambda row: scan_fn(row, *tables, log_param, k))(rows)

    def device_fn(codes):
        n = codes.shape[0]
        if n < k:
            return scan.compute_planes(codes, k, graph.solid.kmers, repeat_set.kmers)
        keys = ("fwd", "valid", "contains", "nb_in", "nb_out", "suffix_rep", "prefix_rep")
        outs = {key: [] for key in keys}
        step = window - halo
        npos = n - k + 1
        takes = []
        pos = 0
        while pos < npos:
            takes.append(min(step, npos - pos))
            pos += step
        nwin = len(takes)

        def materialize(res, g0, gn):
            if packed:
                pays = np.asarray(res["pay8"])
                reps = np.asarray(res["rep8"])
                for j in range(gn):
                    s = (g0 + j) * step
                    chunk = np.full(window, 255, np.uint8)
                    part = codes[s : s + window]
                    chunk[: part.shape[0]] = part
                    pw = planes_from_pay(pays[j], reps[j], chunk, k)
                    take = takes[g0 + j]
                    for key in keys:
                        outs[key].append(getattr(pw, key)[:take])
                return
            for key in keys:
                arr = np.asarray(res[key])
                for j in range(gn):
                    outs[key].append(arr[j, : takes[g0 + j]])

        # double-buffered: dispatch group g asynchronously, then
        # materialize group g-1 while the device works
        pending = None
        for g0 in range(0, nwin, group):
            gn = min(group, nwin - g0)
            # always the full [group, window] shape — a short remainder
            # group is padded, so exactly ONE program shape compiles
            rows = np.full((group, window), 255, np.uint8)
            for j in range(gn):
                s = (g0 + j) * step
                part = codes[s : s + window]
                rows[j, : part.shape[0]] = part
            res = scan_group(jnp.asarray(rows), *targs)
            if pending is not None:
                materialize(*pending)
            pending = (res, g0, gn)
        if pending is not None:
            materialize(*pending)
        return Planes(**{key: np.concatenate(outs[key]) for key in keys})

    return device_fn


def _make_sharded_mem_plane_fn(graph, repeat_set, k: int, host_fn, chunk: int = 1 << 20):
    """Over-HBM scan engine (SURVEY.md §2.3 last row / §5.8): the solid set
    is sharded by contiguous key range across the mesh and every membership
    probe — canonical k-mer plus the 8 strand-aware neighbors — routes to
    its owner shard via Bloom-prefiltered all_to_all
    (parallel/sharded_membership.py). The per-chip footprint is
    |solid|/n_dev keys instead of the full replicated map; results are
    byte-identical to the host oracle (exactness: Bloom negatives are
    one-sided, positives resolve on the owner's exact sorted shard).

    The (k-1)-mer repeat set stays replicated (it is bounded by the
    reference genome, ~1000x smaller than a read-set solid map)."""
    from ..parallel import mesh as M
    from ..parallel.sharded_membership import ShardedMembership
    from .scan import Planes, _member_sorted

    mesh = M.make_mesh()
    if mesh.devices.size < 2:
        raise RuntimeError("sharded-mem needs a multi-device mesh")
    sm = ShardedMembership(mesh, np.asarray(graph.solid.kmers, np.uint64))
    rep_kmers = repeat_set.kmers
    mask = K.kmer_mask(k)
    km1_mask = K.kmer_mask(k - 1)
    shift_hi = np.uint64(2 * (k - 1))

    def fn(codes):
        fwd_all, valid_all = K.kmers_from_codes(codes, k)
        p = fwd_all.shape[0]
        if p == 0:
            return host_fn(codes)
        outs = {key: [] for key in ("contains", "nb_in", "nb_out")}
        for lo in range(0, p, chunk):
            fwd = fwd_all[lo : lo + chunk]
            # 9 membership queries per position, ONE routed batch
            qs = [K.canonical_u64(fwd, k)]
            for x in range(4):
                out_n = ((fwd << np.uint64(2)) | np.uint64(x)) & mask
                qs.append(K.canonical_u64(out_n, k))
            for x in range(4):
                in_n = (fwd >> np.uint64(2)) | (np.uint64(x) << shift_hi)
                qs.append(K.canonical_u64(in_n, k))
            res = sm.contains(np.concatenate(qs)).reshape(9, fwd.shape[0])
            contains = res[0]
            nb_out = np.where(contains, res[1:5].sum(axis=0), 0).astype(np.int32)
            nb_in = np.where(contains, res[5:9].sum(axis=0), 0).astype(np.int32)
            outs["contains"].append(contains)
            outs["nb_out"].append(nb_out)
            outs["nb_in"].append(nb_in)
        suffix = fwd_all & km1_mask
        prefix = (fwd_all >> np.uint64(2)) & km1_mask
        return Planes(
            valid=valid_all,
            fwd=fwd_all,
            contains=np.concatenate(outs["contains"]),
            nb_in=np.concatenate(outs["nb_in"]),
            nb_out=np.concatenate(outs["nb_out"]),
            suffix_rep=np.asarray(_member_sorted(rep_kmers, K.canonical_u64(suffix, k - 1), np)),
            prefix_rep=np.asarray(_member_sorted(rep_kmers, K.canonical_u64(prefix, k - 1), np)),
        )

    return fn


def _make_sharded_plane_fn(graph, repeat_set, k: int, host_fn, window: int = 1 << 22):
    """Window-sharded scan over the full device mesh (the sequence-parallel
    axis, SURVEY.md §5.7): each chromosome is cut into k-1-halo'd windows
    laid out across devices; the fused quotient map is replicated and
    placed ONCE; dispatch groups have a fixed [n_dev, window] shape (one
    compile) and group g-1 materializes while group g computes — the same
    double-buffered discipline as the tuned single-device engine. Output
    planes are stitched in position order, so every downstream artifact is
    byte-identical to the single-device run."""
    from ..ops import extmap as X
    from ..parallel import mesh as M
    from .scan import Planes
    from .scan_device import planes_from_pay

    mesh = M.scan_mesh()
    use_qp = k <= 32  # pair-coalesced map; spans ride the packed
    #                   multi-word map (make_sharded_scan_group_span)
    if use_qp:
        qm = X.build_fused_pair(graph.solid.kmers, k, repeat_set.kmers)
        dispatch, n_dev = M.make_sharded_scan_group_qp(mesh, qm, k, window)
        keys = ("fwd", "valid", "contains", "nb_in", "nb_out", "suffix_rep", "prefix_rep")
    else:
        from .scan_device import planes_from_pay_span

        qms = _build_span_map(graph, repeat_set, k)
        dispatch, n_dev = M.make_sharded_scan_group_span(mesh, qms, k, window)
        keys = ("fwd", "valid", "contains", "nb_in", "nb_out",
                "suffix_rep", "prefix_rep", "fwd_rows")
    halo = k - 1
    step = window - halo

    def sharded_fn(codes):
        n = codes.shape[0]
        if n < k:
            return host_fn(codes)
        npos = n - k + 1
        nwin = -(-npos // step)
        takes = [min(step, npos - i * step) for i in range(nwin)]
        outs = {key: [] for key in keys}

        def materialize(res, wins, g0, gn):
            # both layouts ship packed payload streams off the mesh
            # (~1.125 B/position); planes are rebuilt here on host
            if not use_qp:
                for j in range(gn):
                    pw = planes_from_pay_span(
                        np.asarray(res["pay8"][j]), np.asarray(res["rep8"][j]),
                        np.asarray(res["str8"][j]), wins[j], k,
                    )
                    for key in keys:
                        outs[key].append(getattr(pw, key)[: takes[g0 + j]])
                return
            pays = np.asarray(res["pay8"])
            reps = np.asarray(res["rep8"])
            for j in range(gn):
                pw = planes_from_pay(pays[j], reps[j], wins[j], k)
                for key in keys:
                    outs[key].append(getattr(pw, key)[: takes[g0 + j]])

        pending = None
        for g0 in range(0, nwin, n_dev):
            gn = min(n_dev, nwin - g0)
            wins = np.full((n_dev, window), 255, np.uint8)
            for j in range(gn):
                s = (g0 + j) * step
                part = codes[s : s + window]
                wins[j, : part.shape[0]] = part
            res = dispatch(wins)
            if pending is not None:
                materialize(*pending)
            pending = (res, wins, g0, gn)
        if pending is not None:
            materialize(*pending)
        return Planes(**{key: np.concatenate(outs[key]) for key in keys})

    return sharded_fn


def _make_span_plane_fn(engine: str, graph, repeat_set, k: int, host_fn):
    """Device scan engine for 32 < k <= 256 (multi-word quotient map,
    scan_device.scan_planes_device_q_span)."""
    if engine == "auto" and _auto_small_or_cpu(graph):
        return host_fn

    import jax.numpy as jnp

    from .scan import Planes

    qms = _build_span_map(graph, repeat_set, k)
    d = {
        "slots": jnp.asarray(qms.slots),
        "sat": jnp.asarray(qms.sat),
        "sk": jnp.asarray(qms.stash_key64),
        "ss": jnp.asarray(qms.stash_sat),
        "sv": jnp.asarray(qms.stash_payload),
    }

    window = 1 << 21
    halo = k - 1

    from .scan_device import planes_from_pay_span, scan_pay_device_q_span

    def device_fn(codes):
        n = codes.shape[0]
        if n < k:
            return host_fn(codes)
        # packed path: only the payload byte + 2 bit-planes leave the
        # device (~1.25 B/position vs fwd_words + planes at
        # 8*ceil(k/32)+10 B); fwd/valid re-extracted host-side.
        # Double-buffered: window g-1 materializes while g computes.
        keys = ("fwd", "valid", "contains", "nb_in", "nb_out",
                "suffix_rep", "prefix_rep", "fwd_rows")
        outs = {key: [] for key in keys}
        npos = n - k + 1

        def materialize(res, chunk, take):
            pw = planes_from_pay_span(
                np.asarray(res["pay8"]), np.asarray(res["rep8"]),
                np.asarray(res["str8"]), chunk, k,
            )
            for key in keys:
                outs[key].append(getattr(pw, key)[:take])

        pending = None
        pos = 0
        while pos < npos:
            take = min(window - halo, npos - pos)
            chunk = np.full(window, 255, np.uint8)
            chunk[: min(take + halo, n - pos)] = codes[pos : pos + take + halo]
            res = scan_pay_device_q_span(
                jnp.asarray(chunk), d["slots"], d["sat"], d["sk"], d["ss"], d["sv"],
                qms.salt, qms.log_size, k,
            )
            if pending is not None:
                materialize(*pending)
            pending = (res, chunk, take)
            pos += take
        if pending is not None:
            materialize(*pending)
        return Planes(**{key: np.concatenate(outs[key]) for key in keys})

    return device_fn


def _make_pay_feed_fn(engine: str, graph, repeat_set, k: int, scan_memory_mb: int = 0):
    """Packed-payload scan feed for the NATIVE automaton (the fastest CLI
    path): returns a factory `codes -> iterator of (pay, rep_bits, str_bits,
    n)` chunks for NativeScanner.scan_sequence_pay, or None when this
    engine/backend combination should use the plane path instead.

    Only the fused payload byte stream (+ bit-packed repeat/strand planes,
    ~1.125 B/position) crosses the device->host boundary; the C automaton
    rolls fwd k-mers and validity from the raw sequence itself, so the host
    plane expansion (the old planes_from_pay numpy pass + ~20 B/position of
    plane arrays) disappears entirely. Replay of window g-1 overlaps the
    device compute of window g. Engines: auto / device-qp (k<=32 pair map),
    device (k>32 span map), sharded (either, windows over the mesh)."""
    if engine not in ("auto", "device", "device-qp", "sharded") or k > 256:
        return None
    # same gates, same order, as _make_plane_fn: over-budget replicated
    # map -> sharded-mem (the plane path handles it); auto on small sets /
    # CPU backend -> host plane path
    if k <= 32 and engine in ("auto", "sharded") and _over_budget_mesh(graph, scan_memory_mb):
        return None
    if engine == "auto" and _auto_small_or_cpu(graph):
        return None
    if engine == "device" and k <= 32:
        return None  # explicit 2-probe cuckoo layout has no packed kernel

    import jax
    import jax.numpy as jnp

    from ..ops import extmap as X

    span_mode = k > 32
    mode = "pay"
    pay_one = None
    if engine == "sharded":
        from ..parallel import mesh as M

        mesh = M.scan_mesh()
        window = 1 << 22 if not span_mode else 1 << 21
        if span_mode:
            qms = _build_span_map(graph, repeat_set, k)
            dispatch, group = M.make_sharded_scan_group_span(mesh, qms, k, window)
        else:
            qp = X.build_fused_pair(graph.solid.kmers, k, repeat_set.kmers)
            dispatch, group = M.make_sharded_scan_group_qp(mesh, qp, k, window)
        dispatch_rows = dispatch
    elif span_mode:
        from .scan_device import pack_codes_host, scan_pay_device_q_span, unpack_codes_device

        qms = _build_span_map(graph, repeat_set, k)
        targs = (jnp.asarray(qms.slots), jnp.asarray(qms.sat), jnp.asarray(qms.stash_key64),
                 jnp.asarray(qms.stash_sat), jnp.asarray(qms.stash_payload))
        window = 1 << 21
        group = 4

        @jax.jit
        def pay_group_span(packed, bad, *t):
            rows = unpack_codes_device(packed, bad)
            return jax.vmap(
                lambda r: scan_pay_device_q_span(r, *t, qms.salt, qms.log_size, k)
            )(rows)

        def dispatch_rows(rows):
            packed, bad = pack_codes_host(rows)
            return pay_group_span(jnp.asarray(packed), jnp.asarray(bad), *targs)
    else:
        # flagship single-device path: 2-bit packed upload (0.375 B/base)
        # + reference-delta class download (~0.27 B/position)
        from .scan_device import (
            pack_codes_host, scan_cls_device_qp, scan_pay_device_qp, unpack_codes_device,
        )

        mode = "cls"
        qp = X.build_fused_pair(graph.solid.kmers, k, repeat_set.kmers)
        targs = (jnp.asarray(qp.slots), jnp.asarray(qp.stash_keys),
                 jnp.asarray(qp.stash_l), jnp.asarray(qp.stash_r))
        qp.slots = None  # free the host copy of the ~16 B/slot table —
        #                  only the device placement is used from here
        window = 1 << 22
        group = 3  # small groups -> more pipeline stages: replay of
        #            group g-1 overlaps device compute of group g
        #            (not measured on the H100)
        exc_cap = (window - k + 2 + 3) // 4 * 4 // 8  # 12.5% of payload entries

        @jax.jit
        def cls_group(packed, bad, *t):
            return jax.vmap(
                lambda r, b: scan_cls_device_qp(r, b, *t, qp.log_size, k, exc_cap)
            )(packed, bad)

        @jax.jit
        def pay_one_fn(packed, bad, *t):
            # dense fallback for an exception-overflow window
            row = unpack_codes_device(packed, bad)
            return scan_pay_device_qp(row, *t, qp.log_size, k)

        def dispatch_rows(rows):
            packed, bad = pack_codes_host(rows)
            return cls_group(jnp.asarray(packed), jnp.asarray(bad), *targs)

        def pay_one(row):
            packed, bad = pack_codes_host(row)
            return pay_one_fn(jnp.asarray(packed), jnp.asarray(bad), *targs)

    halo = k - 1
    step = window - halo

    def feed(codes):
        npos = codes.shape[0] - k + 1
        if npos <= 0:
            return
        nwin = -(-npos // step)
        takes = [min(step, npos - i * step) for i in range(nwin)]

        def n_feed_of(w):
            # the global payload stream has npos+1 entries; the final
            # window contributes its take + 1
            return takes[w] + (1 if w == nwin - 1 else 0)

        def emit_cls(res, rows, g0, gn):
            cls2 = np.asarray(res["cls2"])
            nexc = np.asarray(res["n_exc"])
            exc16 = np.asarray(res["exc16"])
            for j in range(gn):
                n_feed = n_feed_of(g0 + j)
                if int(nexc[j]) > exc_cap:
                    # exception-heavy window: re-dispatch dense
                    r = pay_one(rows[j])
                    yield ("pay", np.asarray(r["pay8"])[:n_feed],
                           np.asarray(r["rep8"]), None, n_feed)
                else:
                    yield ("cls", cls2[j], exc16[j], int(nexc[j]), n_feed)

        def emit_pay(res, rows, g0, gn):
            pays = np.asarray(res["pay8"])
            reps = np.asarray(res["rep8"])
            strs = np.asarray(res["str8"]) if span_mode else None
            for j in range(gn):
                n_feed = n_feed_of(g0 + j)
                yield ("pay", pays[j][:n_feed], reps[j],
                       strs[j] if span_mode else None, n_feed)

        emit = emit_cls if mode == "cls" else emit_pay

        pending = None
        for g0 in range(0, nwin, group):
            gn = min(group, nwin - g0)
            rows = np.full((group, window), 255, np.uint8)
            for j in range(gn):
                s = (g0 + j) * step
                part = codes[s : s + window]
                rows[j, : part.shape[0]] = part
            res = dispatch_rows(rows)
            if pending is not None:
                yield from emit(*pending)
            pending = (res, rows, g0, gn)
        if pending is not None:
            yield from emit(*pending)

    return feed


def _build_span_map(graph, repeat_set, k: int):
    """QMapSpan over the solid/repeat sets (shared by the span scan paths)."""
    from ..ops import extmap as X
    from ..ops.span import Span

    sp = Span(k)
    spm1 = Span(k - 1)
    solid_rows = sp.from_keys(graph.solid.keys)
    if repeat_set.span is None:  # k = 33: (k-1)-mer set is plain u64
        rep_rows = np.asarray(repeat_set.keys, np.uint64).reshape(-1, 1)
    else:
        rep_rows = spm1.from_keys(repeat_set.keys)
    return X.build_fused_span(solid_rows, k, rep_rows)


def run_find(opts: dict, out=None) -> Properties:
    """Execute the find module. opts uses the reference option names
    (without leading dash)."""
    import sys

    out = out or sys.stdout

    has_graph = bool(opts.get("graph"))
    has_in = bool(opts.get("in"))
    if has_graph == has_in:
        raise FinderError(
            "ERROR: options -graph and -in are incompatible, but at least one of these is mandatory"
        )
    if not opts.get("ref"):
        raise FinderError("ERROR: option -ref is mandatory")

    if not opts.get("out"):
        opts["out"] = default_output_prefix()
    prefix = opts["out"]

    from ..utils.phases import PhaseTimer, maybe_trace

    phases = PhaseTimer()
    trace_ctx = maybe_trace(opts.get("profile-trace"))
    trace_ctx.__enter__()

    t0 = time.time()
    if has_in:
        with phases.phase("graph build"):
            graph = dbg.build_graph(
                opts["in"],
                int(opts.get("kmer-size", 31)),
                opts.get("abundance-min", "auto"),
                int(opts.get("abundance-max", 2147483647)),
                count_engine=str(opts.get("count-engine", "auto")),
                max_memory_mb=int(opts.get("max-memory", 2000)),
                max_disk_mb=int(opts.get("max-disk", 0)),
                tmp_prefix=str(opts.get("out-tmp", ".")) or None,
            )
            k = int(opts.get("kmer-size", 31))
            graph.save(prefix + ".h5")
    else:
        with phases.phase("graph load"):
            graph = dbg.Graph.load(opts["graph"])
            k = graph.k

    bed_file = opts.get("bed", "")

    # mode flags (src/Finder.cpp:320-398)
    homo_only = False
    homo_insert = True
    hete_insert = True
    snp = True
    backup = False
    deletion = True
    small_homo = True

    if opts.get("homo-only"):
        homo_only, homo_insert, hete_insert, snp, backup, deletion = True, True, False, True, False, True
    if opts.get("insert-only"):
        homo_only, homo_insert, hete_insert, snp, backup, deletion = False, True, True, False, False, False
    if opts.get("snp-only"):
        homo_only, homo_insert, hete_insert, snp, backup, deletion = True, False, False, True, False, False
    if opts.get("deletion-only"):
        homo_only, homo_insert, hete_insert, snp, backup, deletion = True, False, False, False, False, True
    if opts.get("hete-only"):
        homo_only, homo_insert, hete_insert, snp, backup, deletion = False, False, True, False, False, False
    if opts.get("backup"):
        backup = True
    if opts.get("no-snp"):
        snp = False
    if opts.get("no-insert"):
        homo_insert = False
    if opts.get("no-deletion"):
        deletion = False
    if opts.get("no-hetero"):
        hete_insert = False

    max_repeat = int(opts.get("max-rep", 5))
    het_max_occ = max(1, int(opts.get("het-max-occ", 1)))
    snp_min_val = int(opts.get("snp-min-val", 5))
    branching_threshold = int(opts.get("branching-filter", 15))

    breakpoint_name = prefix + ".breakpoints"
    vcf_name = prefix + ".othervariants.vcf"

    ref_uri = opts["ref"]
    with phases.phase("reference repeat set"):
        repeat_set = dbg.build_repeat_set(ref_uri, k - 1, het_max_occ + 1)

    from . import native_scan

    automaton = opts.get("automaton", "auto")
    use_native = (
        automaton in ("auto", "native") and k <= 256 and native_scan.available()
    )

    with open(breakpoint_name, "w") as bkpt_f, open(vcf_name, "w") as vcf_f:
        _write_vcf_header(vcf_f, opts)

        flags = dict(
            max_repeat=max_repeat, snp_min_val=snp_min_val,
            branching_threshold=branching_threshold, homo_only=homo_only,
        )
        if use_native:
            ctx = native_scan.NativeScanner(
                graph, repeat_set, k, **flags,
                snp=snp, deletion=deletion, small_homo=small_homo,
                homo_insert=homo_insert, backup=backup, hete_insert=hete_insert,
            )
        else:
            ctx = ScanContext(graph, repeat_set, k, bkpt_f, vcf_f, **flags)
            # registration order = priority (src/Finder.cpp:548-582)
            if snp:
                ctx.add_gap_observer(O.FindSoloSNP(ctx))
                ctx.add_gap_observer(O.FindMultiSNP(ctx))
                ctx.add_gap_observer(O.FindMultiSNPrev(ctx))
            if deletion:
                ctx.add_gap_observer(O.FindDeletion(ctx))
            if small_homo:
                ctx.add_gap_observer(O.FindSmallCleanInsertion(ctx))
                ctx.add_gap_observer(O.FindSmallFuzzyInsertion(ctx))
            if homo_insert:
                ctx.add_gap_observer(O.FindCleanInsertion(ctx))
                ctx.add_gap_observer(O.FindFuzzyInsertion(ctx))
            if backup:
                ctx.add_gap_observer(O.FindBackup(ctx))
            if hete_insert:
                ctx.add_kmer_observer(O.FindHeteroInsertion(ctx))

        refbank = Bank.open(ref_uri)
        verbose = int(opts.get("verbose", 1))
        progress = Progress(
            refbank.estimate_sequences_size(), "Finding breakpoints", enabled=verbose > 0
        )
        with phases.phase("scan engine setup"):
            scan_engine = opts.get("scan-engine", "auto")
            _validate_scan_engine(scan_engine)
            scan_mem = int(opts.get("scan-memory", 0))
            # native automaton + packed-capable engine: the fused payload
            # stream feeds the C scanner directly (no host plane expansion;
            # replay overlaps device compute)
            pay_feed = (
                _make_pay_feed_fn(scan_engine, graph, repeat_set, k, scan_memory_mb=scan_mem)
                if use_native else None
            )
            plane_fn = (
                None if pay_feed is not None
                else _make_plane_fn(scan_engine, graph, repeat_set, k, scan_memory_mb=scan_mem)
            )
        for rec in refbank:
            codes = dna.seq_to_codes(rec.seq)
            bed_intervals = None
            if bed_file:
                bed_intervals = parse_bed_for_chrom(bed_file, rec.comment_short, k)
            if pay_feed is not None:
                with phases.phase("scan+replay (fused)"):
                    ctx.scan_sequence_pay(rec.comment_short, rec.seq, pay_feed(codes), bed_intervals)
            else:
                with phases.phase("scan planes"):
                    planes = plane_fn(codes)
                with phases.phase("automaton replay"):
                    ctx.scan_sequence(rec.comment_short, rec.seq, planes, bed_intervals)
            progress.inc(len(rec.seq))
        progress.finish()

        if use_native:
            bkpt_text, vcf_text, native_stats = ctx.results()
            bkpt_f.write(bkpt_text)
            vcf_f.write(vcf_text)
            ctx.close()
            from .automaton import FindStats

            stats = FindStats(**native_stats)
            ctx = _StatsHolder(stats)

    seconds = time.time() - t0
    trace_ctx.__exit__(None, None, None)
    info = _resume(opts, graph, ctx, k, seconds, breakpoint_name, vcf_name,
                   max_repeat, het_max_occ, branching_threshold,
                   homo_insert, hete_insert, snp, deletion, bed_file,
                   phases if opts.get("profile") else None)
    out.write(info.dump())
    return info


def _write_vcf_header(vcf_f, opts):
    sample = opts.get("in") or opts.get("graph") or ""
    vcf_f.write(
        "##fileformat=VCFv4.1\n"
        "##filedate=%s"
        "##source=MindTheGap find version %s\n"
        "##SAMPLE=file:%s\n"
        "##REF=file:%s\n"
        '##INFO=<ID=TYPE,Number=1,Type=String,Description="SNP, INS, DEL or .">\n'
        '##INFO=<ID=LEN,Number=1,Type=Integer,Description="variant size">\n'
        '##INFO=<ID=FUZZY,Number=1,Type=Integer,Description="repeat size at the breakpoint, only for INS and DEL">\n'
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tG1\n"
        % (time.ctime() + "\n", MTG_COMPAT_VERSION, sample, opts["ref"])
    )


def _resume(opts, graph, ctx, k, seconds, bkpt_name, vcf_name,
            max_repeat, het_max_occ, branching_threshold,
            homo_insert, hete_insert, snp, deletion, bed_file,
            phases=None) -> Properties:
    s = ctx.stats
    info = Properties()
    info.add(0, "MindTheGap find")
    info.add(1, "version", MTG_COMPAT_VERSION)
    info.add(1, "gatb-core-library", "mindthegap_tpu (JAX/XLA)")
    info.add(1, "supported_kmer_sizes", KSIZE_STRING)
    info.add(0, "Parameters")
    info.add(1, "Input data")
    if opts.get("in"):
        info.add(2, "Reads", opts["in"])
    if opts.get("graph"):
        info.add(2, "Graph", opts["graph"])
    info.add(2, "Reference", opts["ref"])
    if bed_file:
        info.add(2, "Bed file", bed_file)
    info.add(1, "Graph")
    info.add(2, "kmer-size", "%i", k)
    gi = graph.info
    if gi.get("cutoffs_auto.values"):
        info.add(2, "abundance_min (auto inferred)", gi["cutoffs_auto.values"])
    info.add(2, "abundance_min (used)", str(gi.get("thresholds", "")))
    if "abundance_max" in gi:
        info.add(2, "abundance_max", str(gi["abundance_max"]))
    info.add(2, "nb_solid_kmers", str(gi.get("kmers_nb_solid", "")))
    info.add(2, "nb_branching_nodes", str(gi.get("nb_branching", "")))
    info.add(1, "Breakpoint detection options")
    info.add(2, "max_repeat", "%i", max_repeat)
    info.add(2, "hetero_max_occ", "%i", het_max_occ)
    info.add(2, "branching filter value", "%i", branching_threshold)
    info.add(2, "homo_insertions", "yes" if homo_insert else "no")
    info.add(2, "hete_insertions", "yes" if hete_insert else "no")
    info.add(2, "snp", "yes" if snp else "no")
    info.add(2, "deletion", "yes" if deletion else "no")
    info.add(0, "Results")
    info.add(1, "Insertion breakpoints")
    info.add(2, "homozygous", "%i", s.homo_clean + s.homo_fuzzy)
    info.add(3, "clean", "%i", s.homo_clean)
    info.add(3, "fuzzy", "%i", s.homo_fuzzy)
    info.add(2, "heterozygous", "%i", s.hetero_clean + s.hetero_fuzzy)
    info.add(3, "clean", "%i", s.hetero_clean)
    info.add(3, "fuzzy", "%i", s.hetero_fuzzy)
    info.add(1, "Other variants")
    info.add(2, "deletions", "%i", s.clean_deletion + s.fuzzy_deletion)
    info.add(2, "Homozygous insertions 1-2 bp size", "%i", s.homo_clean_indel + s.homo_fuzzy_indel)
    info.add(2, "Heterozygous insertions 1-2 bp size", "%i", s.hetero_indel)
    info.add(2, "SNPs", "%i", s.solo_snp + s.multi_snp)
    info.add(1, "Time", "%.1f s", seconds)
    if phases is not None:
        info.add(1, "Per-phase timings")
        phases.add_to_info(info, 2)
    info.add(1, "Output files")
    if opts.get("in"):
        info.add(2, "graph_file", "%s.h5", opts["out"])
    info.add(2, "breakpoint_file", bkpt_name)
    info.add(2, "othervariants_file", vcf_name)
    return info
