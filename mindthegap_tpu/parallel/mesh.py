"""Multi-chip scale-out: device mesh, sharded scan, distributed counting.

The reference is single-node shared-memory (GATB Dispatcher thread pool,
SURVEY.md §2.3); the device equivalents here are:

- **data-parallel graph build**: read batches sharded over the mesh; each
  device extracts+sorts canonical k-mers and computes a partial abundance
  histogram; histograms are psum-reduced for the `auto` cutoff; per-shard
  sorted runs are gathered and merged (bitwise-or all-reduce when the
  membership structure is a Bloom bitset);
- **window-sharded find scan** (our sequence-parallel axis): the reference
  windows, with k-1 halos, are laid out on a 1-D mesh; the solid/repeat sets
  are replicated; each device runs the plane pass on its windows;
- **job-sharded fill**: gap-fill jobs round-robin over hosts, merged in
  input order (deterministic — strictly better than the reference's
  nondeterministic thread interleave).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..find.scan_device import scan_planes_device, rolling_kmers_device
from ..ops import extmap as X
from ..ops import kmers as K


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def scan_mesh(axis: str = "shard") -> Mesh:
    """Mesh for the window-sharded scan engines. On a single-host CPU
    backend the device count is clamped to the physical core count — the
    virtual devices beyond it only add dispatch overhead and table copies
    (measured: 8 virtual devices on 2 cores run ~0.6x of 2)."""
    import os

    devs = jax.devices()
    n = len(devs)
    if jax.process_count() == 1 and jax.default_backend() == "cpu":
        n = min(n, os.cpu_count() or n)
    return make_mesh(n, axis)


def sharded_scan(mesh: Mesh, windows: np.ndarray, solid_sorted, repeat_sorted, k: int):
    """Run the find-scan plane pass over [n_windows, W] windows sharded on
    the mesh; windows must carry their k-1 halo already. Returns stacked
    planes on host."""
    axis = mesh.axis_names[0]
    win_sharding = NamedSharding(mesh, P(axis, None))
    rep_sharding = NamedSharding(mesh, P())

    windows_d = jax.device_put(jnp.asarray(windows), win_sharding)
    solid_d = jax.device_put(jnp.asarray(solid_sorted), rep_sharding)
    repeat_d = jax.device_put(jnp.asarray(repeat_sorted), rep_sharding)

    @jax.jit
    def run(w, s, r):
        return jax.vmap(lambda row: scan_planes_device(row, s, r, k))(w)

    return jax.tree.map(np.asarray, run(windows_d, solid_d, repeat_d))


class _LazyStack:
    """Per-device async results presented as one stackable array: np.asarray
    blocks and stacks; until then every device's execution stays in flight
    (the caller's double-buffering relies on dispatch returning before the
    group completes)."""

    def __init__(self, parts):
        self.parts = parts

    def __array__(self, dtype=None, copy=None):
        a = np.stack([np.asarray(p) for p in self.parts])
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, i):
        return np.asarray(self.parts[i])


class _LazyAllgather:
    """Multi-host sibling of _LazyStack: local per-device results stay in
    flight until np.asarray, which materializes the local shard and
    process_allgathers the global stack — so the collective for group g-1
    overlaps the local compute of group g. All processes materialize the
    same keys in the same order (same program), keeping collectives
    aligned."""

    def __init__(self, parts):
        self.parts = parts
        self._cached = None

    def __array__(self, dtype=None, copy=None):
        if self._cached is None:
            from jax.experimental import multihost_utils

            loc = np.stack([np.asarray(p) for p in self.parts])
            self._cached = np.asarray(multihost_utils.process_allgather(loc, tiled=True))
        a = self._cached
        return a.astype(dtype) if dtype is not None else a

    def __getitem__(self, i):
        # NOTE: triggers (one) collective — all processes must index the
        # same keys in the same order, which the shared feed loop guarantees
        return self.__array__()[i]


def _perdev_group_dispatch(mesh: Mesh, kernel, table_arrays, window: int):
    """Per-device-executable group dispatcher: each device gets its own
    committed table copy and its own jit instance of `kernel(row, *tables)`;
    a group dispatch launches one execution per device and returns lazily.

    Why not one SPMD program: the scan is an embarrassingly parallel map
    (zero cross-device communication until the host-side merge), and the
    CPU PJRT client executes an SPMD program's per-device partitions
    SEQUENTIALLY (measured: an 8-virtual-device sharded jit runs at ~100%
    of one core; independent per-device executions overlap). Under
    multi-host each process computes its contiguous row block locally and
    the global stack materializes through a LAZY process_allgather — the
    group g-1 collective overlaps group g's local compute. The SPMD
    variant remains behind force_spmd (the multichip dryrun compiles it)."""
    flat = list(mesh.devices.flat)
    n_dev = len(flat)
    multi = jax.process_count() > 1
    if multi:
        pid = jax.process_index()
        local_ids = [i for i, d in enumerate(flat) if d.process_index == pid]
        # tiled allgather reassembles in process order: rows must be a
        # contiguous block per process
        assert local_ids == list(range(local_ids[0], local_ids[0] + len(local_ids)))
    else:
        local_ids = list(range(n_dev))
    devs = [flat[i] for i in local_ids]
    tabs = [
        tuple(jax.device_put(jnp.asarray(t), d) for t in table_arrays) for d in devs
    ]
    fn = jax.jit(kernel)
    wrap = _LazyAllgather if multi else _LazyStack

    def dispatch(wins: np.ndarray):
        assert wins.shape == (n_dev, window)
        outs = [
            fn(jax.device_put(wins[gi], d), *tabs[j])
            for j, (gi, d) in enumerate(zip(local_ids, devs))
        ]
        keys = outs[0].keys()
        return {key: wrap([o[key] for o in outs]) for key in keys}

    return dispatch, n_dev


def make_sharded_scan_group_qp(mesh: Mesh, qp, k: int, window: int, force_spmd: bool = False):
    """Persistent window-sharded scanner over the pair-coalesced map:
    replicated tables are placed on the mesh ONCE; the returned callable
    dispatches a fixed [n_dev, window] group (one compile for the whole
    run) and returns the device result asynchronously — the caller overlaps
    materialization of group g-1 with compute of group g, exactly like the
    single-device engine.

    Outputs are PACKED (VERDICT r4 item 1): the per-window 8-bit fused
    payload stream + bit-packed repeat plane (scan_pay_device_qp,
    ~1.125 B/position) instead of the 7-plane tuple (~20 B/position) — the
    device side also skips the fwd k-mer rolling entirely; the host rebuilds
    planes with planes_from_pay or feeds the stream straight into the native
    automaton (find/native_scan.py scan_sequence_pay). Single-host dispatch
    shards the window group via jit in_shardings (no per-group device_put)."""
    from ..find.scan_device import scan_pay_device_qp

    if not force_spmd and (jax.process_count() > 1 or jax.default_backend() == "cpu"):
        # embarrassingly parallel map: per-device executables + lazy
        # host-side gather beat one SPMD program (see _perdev_group_dispatch)
        return _perdev_group_dispatch(
            mesh,
            lambda row, *t: scan_pay_device_qp(row, *t, qp.log_size, k),
            (qp.slots, qp.stash_keys, qp.stash_l, qp.stash_r),
            window,
        )

    axis = mesh.axis_names[0]
    win_sharding = NamedSharding(mesh, P(axis, None))
    rep_sharding = NamedSharding(mesh, P())

    slots_d = jax.device_put(jnp.asarray(qp.slots), rep_sharding)
    sk_d = jax.device_put(jnp.asarray(qp.stash_keys), rep_sharding)
    sl_d = jax.device_put(jnp.asarray(qp.stash_l), rep_sharding)
    sr_d = jax.device_put(jnp.asarray(qp.stash_r), rep_sharding)

    run = jax.jit(
        lambda w, slots, sk, sl, sr: jax.vmap(
            lambda row: scan_pay_device_qp(row, slots, sk, sl, sr, qp.log_size, k)
        )(w),
        in_shardings=(win_sharding, rep_sharding, rep_sharding, rep_sharding, rep_sharding),
    )

    n_dev = int(mesh.devices.size)
    multi = jax.process_count() > 1

    def dispatch(wins: np.ndarray):
        assert wins.shape == (n_dev, window)
        if multi:
            # multi-host: shards live on remote processes; place + gather
            # globally (synchronous — each process needs the full stream
            # for its own automaton replay)
            from jax.experimental import multihost_utils

            w_d = jax.device_put(jnp.asarray(wins), win_sharding)
            out = run(w_d, slots_d, sk_d, sl_d, sr_d)
            return jax.tree.map(np.asarray, multihost_utils.process_allgather(out, tiled=True))
        return run(wins, slots_d, sk_d, sl_d, sr_d)

    return dispatch, n_dev


def make_sharded_scan_group_span(mesh: Mesh, qms, k: int, window: int, force_spmd: bool = False):
    """Span (32 < k <= 256) sibling of make_sharded_scan_group_qp: windows
    sharded over the mesh, the multi-word quotient map replicated and
    placed once, fixed [n_dev, window] dispatch shape, PACKED outputs
    (payload byte + bit-packed repeat/strand planes — the host rebuilds
    the planes with planes_from_pay_span)."""
    from ..find.scan_device import scan_pay_device_q_span

    if not force_spmd and (jax.process_count() > 1 or jax.default_backend() == "cpu"):
        return _perdev_group_dispatch(
            mesh,
            lambda row, *t: scan_pay_device_q_span(row, *t, qms.salt, qms.log_size, k),
            (qms.slots, qms.sat, qms.stash_key64, qms.stash_sat, qms.stash_payload),
            window,
        )

    axis = mesh.axis_names[0]
    win_sharding = NamedSharding(mesh, P(axis, None))
    rep_sharding = NamedSharding(mesh, P())

    slots_d = jax.device_put(jnp.asarray(qms.slots), rep_sharding)
    sat_d = jax.device_put(jnp.asarray(qms.sat), rep_sharding)
    sk_d = jax.device_put(jnp.asarray(qms.stash_key64), rep_sharding)
    ss_d = jax.device_put(jnp.asarray(qms.stash_sat), rep_sharding)
    sv_d = jax.device_put(jnp.asarray(qms.stash_payload), rep_sharding)

    run = jax.jit(
        lambda w, slots, sat, sk, ss, sv: jax.vmap(
            lambda row: scan_pay_device_q_span(
                row, slots, sat, sk, ss, sv, qms.salt, qms.log_size, k
            )
        )(w),
        in_shardings=(win_sharding,) + (rep_sharding,) * 5,
    )

    n_dev = int(mesh.devices.size)
    multi = jax.process_count() > 1

    def dispatch(wins: np.ndarray):
        assert wins.shape == (n_dev, window)
        if multi:
            from jax.experimental import multihost_utils

            w_d = jax.device_put(jnp.asarray(wins), win_sharding)
            out = run(w_d, slots_d, sat_d, sk_d, ss_d, sv_d)
            return jax.tree.map(np.asarray, multihost_utils.process_allgather(out, tiled=True))
        return run(wins, slots_d, sat_d, sk_d, ss_d, sv_d)

    return dispatch, n_dev


def distributed_count_step(mesh: Mesh, read_codes: np.ndarray, k: int, histo_max: int = 10000):
    """One data-parallel counting step: reads sharded over the mesh; each
    shard extracts + canonicalizes its k-mers, ROUTES every k-mer to its
    owner device by a bijective hash prefix via all_to_all (ICI), sorts what
    it received and run-length encodes. Ownership makes per-device counts
    complete, so the psum of per-device histograms is the EXACT global
    abundance histogram (the collective that feeds the `auto` cutoff).
    Returns (owner-sorted per-shard kmer runs [D, L] padded with the MAX
    sentinel, global histogram). The full streaming version of this step is
    parallel/sharded_count.py ShardedStreamingCounter."""
    from .sharded_count import pick_swizzle_const

    axis = mesh.axis_names[0]
    n = int(mesh.devices.size)
    assert n & (n - 1) == 0, "mesh size must be a power of two"
    log_n = n.bit_length() - 1
    const = np.uint64(pick_swizzle_const(k))
    sentinel = jnp.uint64(0xFFFFFFFFFFFFFFFF)
    rows_total, read_len = read_codes.shape
    per_dev = (rows_total // n) * (read_len - k + 1)
    cap = per_dev // n + max(64, per_dev // (4 * n))

    def shard_fn(codes):  # codes: [rows_per_shard, read_len]
        def row_kmers(row):
            fwd, valid = rolling_kmers_device(row, k)
            canon = K.canonical_u64(fwd, k, jnp)
            return jnp.where(valid, canon, sentinel)

        canon = jax.vmap(row_kmers)(codes).reshape(-1)
        swz = (canon ^ (canon >> jnp.uint64(33))) * const
        swz = swz ^ (swz >> jnp.uint64(29))
        swz = jnp.where(canon == sentinel, sentinel, swz)
        swz, canon = jax.lax.sort((swz, canon), num_keys=1)

        if log_n:
            bounds = jnp.arange(1, n, dtype=jnp.uint64) << jnp.uint64(64 - log_n)
            starts = jnp.concatenate(
                [jnp.zeros(1, jnp.int32), jnp.searchsorted(swz, bounds).astype(jnp.int32)]
            )
        else:
            starts = jnp.zeros(1, jnp.int32)
        end_valid = jnp.searchsorted(swz, sentinel).astype(jnp.int32)
        ends = jnp.maximum(jnp.concatenate([starts[1:], end_valid[None]]), starts)

        idx = starts[:, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
        mask = idx < ends[:, None]
        idx = jnp.minimum(idx, swz.shape[0] - 1)
        send = jnp.where(mask, canon[idx], sentinel)
        recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0)

        owned = jnp.sort(recv.reshape(-1))
        # run-length encode the sorted keys -> complete per-distinct counts
        newrun = jnp.concatenate(
            [jnp.ones(1, jnp.int32), (owned[1:] != owned[:-1]).astype(jnp.int32)]
        )
        run_id = jnp.cumsum(newrun) - 1
        counts = jax.ops.segment_sum(jnp.ones_like(run_id), run_id, num_segments=owned.shape[0])
        starts_m = (newrun == 1) & (owned != sentinel)
        clipped = jnp.clip(jnp.where(starts_m, counts[run_id], 0), 0, histo_max)
        hist = jnp.zeros((histo_max + 1,), jnp.int32).at[clipped].add(starts_m.astype(jnp.int32))
        hist = hist.at[0].set(0)
        ghist = jax.lax.psum(hist, axis)
        return owned, ghist

    shard_fn_mapped = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(axis, None),), out_specs=(P(axis), P())
    )
    rows = jnp.asarray(read_codes)
    kmers_runs, ghist = jax.jit(shard_fn_mapped)(rows)
    return np.asarray(kmers_runs), np.asarray(ghist)


def walk_batch_sharded(mesh: Mesh, nodes: np.ndarray, budgets: np.ndarray, qmap, k: int, steps: int = 64):
    """Job-sharded fill walking: the batched simple-path walker
    (fill/walk_device.py walk_batch_device) with its job-lane axis laid out
    over the mesh and the fused quotient map replicated — the multi-chip
    shape of the reference's Dispatcher fan-out over gap-fill jobs
    (src/Filler.cpp:824,844; SURVEY.md §2.3). Lanes must divide the mesh
    size (BatchWalker pads to powers of two)."""
    from ..fill.walk_device import walk_batch_device

    axis = mesh.axis_names[0]
    lane_sharding = NamedSharding(mesh, P(axis))
    rep_sharding = NamedSharding(mesh, P())

    nodes_d = jax.device_put(jnp.asarray(nodes, jnp.uint64), lane_sharding)
    budgets_d = jax.device_put(jnp.asarray(budgets, jnp.int32), lane_sharding)
    slots_d = jax.device_put(jnp.asarray(qmap.slots), rep_sharding)
    sk_d = jax.device_put(jnp.asarray(qmap.stash_keys), rep_sharding)
    sv_d = jax.device_put(jnp.asarray(qmap.stash_payload), rep_sharding)

    fn = jax.shard_map(
        partial(walk_batch_device, log_size=qmap.log_size, k=k, steps=steps),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P()),
        out_specs=(P(axis, None), P(axis), P(axis), P(axis)),
    )
    bases, n_app, end_nodes, status = jax.jit(fn)(nodes_d, budgets_d, slots_d, sk_d, sv_d)
    return (np.asarray(bases), np.asarray(n_app), np.asarray(end_nodes), np.asarray(status))


def pipeline_step(mesh: Mesh, read_codes: np.ndarray, windows: np.ndarray, solid_sorted, repeat_sorted, k: int):
    """A full multi-chip 'step': distributed counting (dp axis with psum) +
    window-sharded scan (sp axis) + job-sharded fill walking, all over the
    fused quotient map. Used by the multichip dry run."""
    from ..ops import extmap as X

    runs, ghist = distributed_count_step(mesh, read_codes, k)
    qm = X.build_fused(np.asarray(solid_sorted, np.uint64), k, np.asarray(repeat_sorted, np.uint64))
    # the CLI's sharded engine rides the pair-coalesced map through the
    # persistent group dispatcher — exercise the same path here so the
    # dryrun guards it (tables placed once, fixed [n_dev, window] shape)
    qp = X.build_fused_pair(np.asarray(solid_sorted, np.uint64), k, np.asarray(repeat_sorted, np.uint64))
    # force the SPMD path: the dryrun exists to validate the multi-chip
    # sharded compile, not the CPU per-device fallback
    dispatch, nd = make_sharded_scan_group_qp(mesh, qp, k, windows.shape[1], force_spmd=True)
    group = np.full((nd, windows.shape[1]), 255, np.uint8)
    group[: min(nd, windows.shape[0])] = windows[:nd]
    planes = jax.tree.map(np.asarray, dispatch(group))
    n_dev = mesh.devices.size
    nodes = np.asarray(solid_sorted, np.uint64)[: 2 * n_dev]
    budgets = np.full(nodes.shape, 32, np.int32)
    walk = walk_batch_sharded(mesh, nodes, budgets, qm, k, steps=16)
    # sharded membership (Bloom prefilter + all_to_all routing) — the
    # over-HBM membership shape, exercised here so the multichip dryrun
    # covers its collectives too
    from .sharded_membership import ShardedMembership

    sm = ShardedMembership(mesh, np.asarray(solid_sorted, np.uint64))
    probe = np.asarray(solid_sorted, np.uint64)[: 4 * n_dev]
    assert bool(sm.contains(probe).all())
    return runs, ghist, planes, walk
