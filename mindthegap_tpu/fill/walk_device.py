"""Device-batched fill walker: simple-path extension over many jobs at once.

The `fill` hot loop (reference src/Filler.cpp:854-884: per-breakpoint bounded
BFS in the DBG via IterativeExtensions) spends nearly all of its probes on
*uninterrupted simple-path stretches* — per extended base one successor-set
query plus one in-branching check. The traversal automaton
(fill/traversal.py) yields exactly those stretches as ("walk", node, budget)
requests; this module satisfies them for J jobs simultaneously on the
accelerator:

  per step, per job: ONE fused quotient-map lookup (ops/extmap.py QMap,
  2 HBM gathers) yields the successor bitmap of `node` AND the predecessor
  bitmap of its unique successor; a second carried lookup (the next step's
  first) gives the successor bitmap of the successor — everything the walk
  contract needs:

    stop "tip"    when node has no successor
    stop "event"  when node forks (>1 successors), the successor has >1
                  predecessors, or the successor is out-branching — the
                  sparse cases the host automaton replays exactly
                  (bubble/tip crossing, terminator marks)
    stop "budget" when the per-job base budget (max_depth) is exhausted

  Consecutive appended bases therefore occupy the first n_appended slots of
  each job's output row.

This is the SPMD shape SURVEY.md §2.3 calls for ("per-job frontier tensor,
neighbor-expansion kernel"): jobs ride the vector lanes, steps are a
lax.scan, and the map is replicated (or mesh-sharded via shard_map in
parallel/mesh.py walk_batch_sharded).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import extmap as X
from ..ops import kmers as K

STATUS_RUNNING = 0  # budget/steps exhausted; resume from end_node
STATUS_TIP = 1
STATUS_EVENT = 2

NO_BASE = 255


def _popcount4(bits):
    return (
        ((bits >> 0) & 1) + ((bits >> 1) & 1) + ((bits >> 2) & 1) + ((bits >> 3) & 1)
    ).astype(jnp.int32)


@partial(jax.jit, static_argnames=("log_size", "k", "steps", "layout"))
def walk_batch_device(nodes, budgets, slots, stash_k, stash_v, log_size: int, k: int,
                      steps: int, layout: str = "cuckoo"):
    """Advance J simple-path walks by up to `steps` bases each.

    nodes:   u64[J] current k-mers (forward orientation)
    budgets: i32[J] remaining per-job base budgets
    layout:  "cuckoo" (QMap, 2 gathers/probe) or "bucket" (QMapB, 1)

    Returns (bases u8[J, steps] — appended base codes, NO_BASE padding;
    n_appended i32[J]; end_nodes u64[J]; status u8[J])."""
    if layout == "bucket":
        qm = X.QMapB(slots, log_size, stash_k, stash_v)
        lookup = X.lookup_qb
    else:
        qm = X.QMap(slots, log_size, stash_k, stash_v)
        lookup = X.lookup_q
    mask_k = K.kmer_mask(k)
    mask_q = K.kmer_mask(k - 1)

    def ext_pre_of(node):
        """(ext, pre) bitmaps of the (k-1)-suffix of `node`, as-read strand:
        ext = successor set of node, pre = predecessor set of node's unique
        successor (both share that (k-1)-mer)."""
        q = node & mask_q
        cq = K.canonical_u64(q, k - 1, jnp)
        pay16 = lookup(qm, cq, xp=jnp)
        pay8 = (pay16 & jnp.uint16(0xFF)).astype(jnp.uint8)
        return X._oriented(pay8, q == cq, jnp)

    ext0, pre0 = ext_pre_of(nodes)

    def step(carry, _):
        node, ext, pre, n_app, status = carry
        within = n_app < budgets
        live = (status == STATUS_RUNNING) & within

        cnt_out = _popcount4(ext)
        tip = cnt_out == 0
        fork = cnt_out > 1
        # single-successor base: with exactly one bit set, x = its index
        x = (((ext >> 1) & 1) + 2 * ((ext >> 2) & 1) + 3 * ((ext >> 3) & 1)).astype(jnp.uint64)
        nxt = ((node << jnp.uint64(2)) | x) & mask_k
        merge = _popcount4(pre) != 1  # predecessors(nxt) != 1 (merge or in-deg 0)

        ext2, pre2 = ext_pre_of(nxt)
        branch2 = _popcount4(ext2) != 1  # successors(nxt) != 1 => is_branching(nxt)

        stop_tip = live & tip
        stop_event = live & ~tip & (fork | merge | branch2)
        append = live & ~tip & ~fork & ~merge & ~branch2

        base_out = jnp.where(append, x.astype(jnp.uint8), jnp.uint8(NO_BASE))
        status = jnp.where(stop_tip, jnp.uint8(STATUS_TIP), status)
        status = jnp.where(stop_event, jnp.uint8(STATUS_EVENT), status)
        node = jnp.where(append, nxt, node)
        ext = jnp.where(append, ext2, ext)
        pre = jnp.where(append, pre2, pre)
        n_app = n_app + append.astype(jnp.int32)
        return (node, ext, pre, n_app, status), base_out

    # derive the zero carries from `nodes` (not jnp.zeros) so their varying
    # manual axes match the outputs when this runs inside shard_map
    # (parallel/mesh.py walk_batch_sharded): lax.scan requires carry-in and
    # carry-out to agree on mesh-axis vma.
    zeros = nodes & jnp.uint64(0)
    init = (nodes, ext0, pre0, zeros.astype(jnp.int32), zeros.astype(jnp.uint8))
    (node, _, _, n_app, status), bases = jax.lax.scan(step, init, None, length=steps)
    return bases.T, n_app, node, status


def _mask_top_span(words, nbases: int):
    """Keep the low 2*nbases bits of a (W, J) span value (word 0 most
    significant) — the jnp sibling of native Kmer::mask_top."""
    w = words.shape[0]
    full = (2 * nbases) // 64
    rem = 2 * nbases - full * 64
    outs = []
    for i in range(w):
        from_low = w - 1 - i
        if from_low < full:
            outs.append(words[i])
        elif from_low == full and rem:
            outs.append(words[i] & jnp.uint64((1 << rem) - 1))
        else:
            outs.append(jnp.zeros_like(words[i]))
    return jnp.stack(outs)


def _shl2_span(words):
    """(W, J) span value <<= 2 (no mask)."""
    w = words.shape[0]
    outs = []
    for i in range(w - 1):
        outs.append((words[i] << jnp.uint64(2)) | (words[i + 1] >> jnp.uint64(62)))
    outs.append(words[w - 1] << jnp.uint64(2))
    return jnp.stack(outs)


@partial(jax.jit, static_argnames=("salt", "log_size", "k", "steps"))
def walk_batch_device_span(nodes, budgets, slots, sat, stash_k64, stash_sat, stash_v,
                           salt: int, log_size: int, k: int, steps: int):
    """Span sibling (32 < k <= 256) of walk_batch_device: J simple-path
    walks over the multi-word fused quotient map (ops/extmap.py QMapSpan,
    reference traversal at KSIZE spans — src/Filler.cpp:866-884 is span-
    templated, README.md:172-180). nodes: u64[J, Wk] span rows (word 0
    most significant). Same contract/stop reasons as the u64 kernel."""
    from ..ops import span_device as SD

    qm = X.QMapSpan(slots, sat, log_size, salt, stash_k64, stash_sat, stash_v)
    wk = nodes.shape[1]
    wq = SD.span_width(k - 1)

    def ext_pre_of(nodesT):
        q = _mask_top_span(nodesT, k - 1)[wk - wq :]
        cq, is_c = SD.canonical_span_device(q, k - 1)
        pay16 = X.lookup_q_span(qm, cq, xp=jnp)
        pay8 = (pay16 & jnp.uint16(0xFF)).astype(jnp.uint8)
        return X._oriented(pay8, is_c, jnp)

    nodesT = nodes.T  # (Wk, J)
    ext0, pre0 = ext_pre_of(nodesT)

    def step(carry, _):
        node, ext, pre, n_app, status = carry
        within = n_app < budgets
        live = (status == STATUS_RUNNING) & within

        cnt_out = _popcount4(ext)
        tip = cnt_out == 0
        fork = cnt_out > 1
        x = (((ext >> 1) & 1) + 2 * ((ext >> 2) & 1) + 3 * ((ext >> 3) & 1)).astype(jnp.uint64)
        nxt = _shl2_span(node)
        nxt = nxt.at[wk - 1].set(nxt[wk - 1] | x)
        nxt = _mask_top_span(nxt, k)
        merge = _popcount4(pre) != 1

        ext2, pre2 = ext_pre_of(nxt)
        branch2 = _popcount4(ext2) != 1

        stop_tip = live & tip
        stop_event = live & ~tip & (fork | merge | branch2)
        append = live & ~tip & ~fork & ~merge & ~branch2

        base_out = jnp.where(append, x.astype(jnp.uint8), jnp.uint8(NO_BASE))
        status = jnp.where(stop_tip, jnp.uint8(STATUS_TIP), status)
        status = jnp.where(stop_event, jnp.uint8(STATUS_EVENT), status)
        node = jnp.where(append[None, :], nxt, node)
        ext = jnp.where(append, ext2, ext)
        pre = jnp.where(append, pre2, pre)
        n_app = n_app + append.astype(jnp.int32)
        return (node, ext, pre, n_app, status), base_out

    zeros = budgets & jnp.int32(0)
    init = (nodesT, ext0, pre0, zeros, zeros.astype(jnp.uint8))
    (nodeT, _, _, n_app, status), bases = jax.lax.scan(step, init, None, length=steps)
    return bases.T, n_app, nodeT.T, status


class BatchWalker:
    """Host driver: satisfies batches of ("walk", node, budget) requests with
    walk_batch_device, re-invoking in `steps`-sized chunks until every lane
    has stopped. Lane counts are padded to powers of two and step counts
    escalate geometrically so only a handful of shapes ever compile.

    With `mesh` set, job lanes are laid out over the device mesh via
    shard_map (the multi-chip shape of the reference's Dispatcher fan-out
    over gap-fill jobs, src/Filler.cpp:824,844; SURVEY.md §2.3 row 2) with
    the fused quotient map replicated on every device."""

    def __init__(self, qmap, k: int, min_lanes: int = 8, steps: int = 256,
                 max_steps: int = 2048, mesh=None):
        # steps default: each dispatch pays a fixed host round trip while
        # per-step compute is ~2 gathers x lanes — overshooting steps is
        # cheap, undershooting multiplies round trips, so start big and
        # escalate fast (the defaults are not measured on the H100)
        self.k = k
        if isinstance(qmap, X.QMapSpan):
            self.layout = "span"
            from ..ops.span_device import span_width

            self._wk = span_width(k)
            self.log_size = qmap.log_size
            self.salt = qmap.salt
            self.sat = jnp.asarray(qmap.sat)
            self.stash_sat = jnp.asarray(qmap.stash_sat)
            self.slots = jnp.asarray(qmap.slots)
            self.stash_k = jnp.asarray(qmap.stash_key64)
            self.stash_v = jnp.asarray(qmap.stash_payload)
            self.min_lanes = min_lanes
            self.steps = steps
            self.max_steps = max_steps
            self.mesh = None  # span lanes ride one device; mesh sharding
            #                   covers k <= 32 (the u64 row layout)
            self.n_device_calls = 0
            self.n_walked = 0
            return
        self.layout = "bucket" if isinstance(qmap, X.QMapB) else "cuckoo"
        self.log_size = qmap.log_nb if self.layout == "bucket" else qmap.log_size
        self.mesh = mesh
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            n_dev = int(mesh.devices.size)
            assert n_dev & (n_dev - 1) == 0, "mesh size must be a power of two"
            axis = mesh.axis_names[0]
            self._axis = axis
            self._lane_sharding = NamedSharding(mesh, P(axis))
            rep = NamedSharding(mesh, P())
            self.slots = jax.device_put(jnp.asarray(qmap.slots), rep)
            self.stash_k = jax.device_put(jnp.asarray(qmap.stash_keys), rep)
            self.stash_v = jax.device_put(jnp.asarray(qmap.stash_payload), rep)
            self.min_lanes = max(min_lanes, n_dev)
            self._sharded_fns: dict[int, object] = {}
        else:
            self.slots = jnp.asarray(qmap.slots)
            self.stash_k = jnp.asarray(qmap.stash_keys)
            self.stash_v = jnp.asarray(qmap.stash_payload)
            self.min_lanes = min_lanes
        self.steps = steps
        self.max_steps = max_steps
        self.n_device_calls = 0
        self.n_walked = 0

    def _call_device(self, nodes, budgets, steps: int):
        if self.layout == "span":
            return walk_batch_device_span(
                nodes, budgets, self.slots, self.sat, self.stash_k,
                self.stash_sat, self.stash_v, self.salt, self.log_size,
                self.k, steps,
            )
        if self.mesh is None:
            return walk_batch_device(
                nodes, budgets, self.slots, self.stash_k, self.stash_v,
                self.log_size, self.k, steps, self.layout,
            )
        fn = self._sharded_fns.get(steps)
        if fn is None:
            from jax.sharding import PartitionSpec as P

            axis = self._axis
            fn = jax.jit(jax.shard_map(
                partial(walk_batch_device, log_size=self.log_size, k=self.k,
                        steps=steps, layout=self.layout),
                mesh=self.mesh,
                in_specs=(P(axis), P(axis), P(), P(), P()),
                out_specs=(P(axis, None), P(axis), P(axis), P(axis)),
            ))
            self._sharded_fns[steps] = fn
        nodes = jax.device_put(nodes, self._lane_sharding)
        budgets = jax.device_put(budgets, self._lane_sharding)
        return fn(nodes, budgets, self.slots, self.stash_k, self.stash_v)

    def walk_many(self, requests):
        """requests: list of (node:int, budget:int). Returns a list of
        (bases: list[int], end_node: int, reason: str) in request order."""
        n = len(requests)
        if n == 0:
            return []
        lanes = max(self.min_lanes, 1 << (n - 1).bit_length())
        span = self.layout == "span"
        if span:
            wk = self._wk
            nodes = np.zeros((lanes, wk), np.uint64)
            m64 = (1 << 64) - 1
            for i, (node, budget) in enumerate(requests):
                v = int(node)
                for w in range(wk):
                    nodes[i, wk - 1 - w] = (v >> (64 * w)) & m64
        else:
            nodes = np.zeros(lanes, np.uint64)
        budgets = np.zeros(lanes, np.int32)
        for i, (node, budget) in enumerate(requests):
            if not span:
                nodes[i] = node
            budgets[i] = max(budget, 0)

        out_bases: list[list[int]] = [[] for _ in range(n)]
        remaining = budgets.copy()
        status = np.zeros(lanes, np.uint8)
        steps = self.steps
        while True:
            live = (status == STATUS_RUNNING) & (remaining > 0)
            if not live.any():
                break
            bases, n_app, end_nodes, st = self._call_device(
                jnp.asarray(nodes), jnp.asarray(np.where(live, remaining, 0)), steps
            )
            bases = np.asarray(bases)
            n_app = np.asarray(n_app)
            nodes = np.asarray(end_nodes)
            st = np.asarray(st)
            self.n_device_calls += 1
            for i in np.nonzero(live[:n])[0]:
                if n_app[i]:
                    out_bases[i].extend(int(b) for b in bases[i, : n_app[i]])
            remaining = remaining - n_app
            status = np.where(live, st, status)
            self.n_walked += int(n_app[live].sum())
            steps = min(steps * 2, self.max_steps)

        results = []
        for i in range(n):
            st = int(status[i])
            reason = "tip" if st == STATUS_TIP else ("event" if st == STATUS_EVENT else "budget")
            if span:
                end = 0
                for w in range(self._wk):
                    end = (end << 64) | int(nodes[i, w])
            else:
                end = int(nodes[i])
            results.append((out_bases[i], end, reason))
        return results


def run_jobs_batched(gens, walker: BatchWalker):
    """Drive many traversal coroutines concurrently: collect every pending
    ("walk", node, budget) request, satisfy the whole batch on device, feed
    results back, repeat. Jobs block only on walks, so batches stay full
    until the long tail drains. Yields each coroutine's return value in
    input order, streaming finished prefixes as they complete (so writers
    and the progress bar advance before the long tail drains)."""
    n = len(gens)
    results = [None] * n
    done = [False] * n
    pending: dict[int, tuple] = {}

    def advance(i, value, first):
        try:
            req = next(gens[i]) if first else gens[i].send(value)
            pending[i] = req
        except StopIteration as e:
            results[i] = e.value
            done[i] = True

    for i in range(n):
        advance(i, None, True)
    next_emit = 0
    while next_emit < n and done[next_emit]:
        yield results[next_emit]
        results[next_emit] = None
        next_emit += 1
    while pending:
        idxs = sorted(pending)
        reqs = [pending.pop(i) for i in idxs]
        outs = walker.walk_many([(r[1], r[2]) for r in reqs])
        for i, out in zip(idxs, outs):
            advance(i, out, False)
        while next_emit < n and done[next_emit]:
            yield results[next_emit]
            results[next_emit] = None
            next_emit += 1
    while next_emit < n:
        yield results[next_emit]
        results[next_emit] = None
        next_emit += 1
