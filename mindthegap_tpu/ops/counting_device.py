"""Device-side canonical k-mer counting (the DSK equivalent's hot half).

Graph build is the reference's #1 hot loop (SURVEY.md §3 ranking: DSK
counting over all reads). The host path (ops/counting.py StreamingCounter)
extracts + sorts on CPU; this path moves the per-base work — rolling k-mer
extraction, canonicalization, and the sort — onto the accelerator as one
fused jit program per batch:

  codes[B] (uint8, reads concatenated with 255 separators)
    -> forward k-mers + validity (separator windows invalid)
    -> canonical min(fwd, revcomp)
    -> invalid lanes -> 0xFFFF... sentinel
    -> jnp.sort (bitonic on device)

The host keeps only the merge of sorted runs (ops/counting.py merge), i.e.
the same structure a multi-chip build all-merges — see
parallel/mesh.py distributed_count_step for the sharded version with the
psum histogram all-reduce.

k <= 32 (uint64 lanes). Larger spans use the host counter.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import kmers as K

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
SEP = 255  # read separator / invalid base code


class DeviceStreamingCounter:
    """Drop-in for ops/counting.py StreamingCounter (k <= 32): batches of
    base codes are concatenated with separators into fixed-size device
    buffers; each flush sorts its batch on device (sort_batch_device) and
    MERGES the raw sorted stream into a DEVICE-RESIDENT accumulator
    (merge_sorted_device folds duplicates while merging — no per-batch
    RLE/compaction pass) — nothing but one scalar (the running distinct
    count, which doubles as the capacity-overflow check and the
    buffer-reuse sync) crosses the host boundary until result(). Uploads
    are 2-bit packed (+ bad/separator bitmask): 0.375 B/base instead of 1.
    The r4 version transferred every flush's distinct prefix
    (~12 B/distinct) and merged on host, which held the CLI wrapper at a
    quarter of the one-shot kernel's rate."""

    def __init__(self, k: int, batch_bases: int = 1 << 23, init_cap: int = 1 << 20):
        assert k <= 32, "device counter: k <= 32 (host counter covers larger spans)"
        self.k = k
        self._batch = int(batch_bases) & ~7  # pack_codes_host needs n % 8 == 0
        # the mid-read flush rewinds k-1 bases; the per-iteration advance must
        # exceed the rewind or add_codes never progresses
        assert self._batch >= 2 * k, "batch_bases must be >= 2*k"
        # TWO staging buffers, used alternately: a buffer is only refilled
        # after the flush that read it has been synced (scalar readback of
        # its merge's distinct count). One flush stays in flight.
        self._bufs = [np.full(self._batch, SEP, np.uint8) for _ in range(2)]
        self._cur = 0
        self._fill = 0
        self._cap = int(init_cap)
        self._acc = None  # (keys_dev[cap], counts_dev[cap]) sorted distinct
        self._acc_n = 0
        self._pending = None  # (acc_prev, batch_triple, merge_triple, cap)

    def add_codes(self, codes: np.ndarray):
        codes = np.asarray(codes, np.uint8)
        n = codes.size
        fill = self._fill
        if n + 1 <= self._batch - fill:  # whole read fits: no loop, no min()
            buf = self._bufs[self._cur]
            buf[fill : fill + n] = codes
            buf[fill + n] = SEP
            self._fill = fill + n + 1
            return
        pos = 0
        while True:
            take = min(n - pos, self._batch - self._fill)
            self._buf[self._fill : self._fill + take] = codes[pos : pos + take]
            self._fill += take
            pos += take
            if pos >= n:
                if self._fill < self._batch:
                    self._buf[self._fill] = SEP  # read boundary
                    self._fill += 1
                else:
                    self._flush()
                return
            # buffer full mid-read: flush, then rewind k-1 bases so the
            # windows spanning the split are counted exactly once
            self._flush()
            pos = max(pos - (self.k - 1), 0)

    @property
    def _buf(self):
        return self._bufs[self._cur]

    def _flush(self):
        from ..find.scan_device import pack_codes_host

        if self._fill == 0:
            return
        buf = self._bufs[self._cur]
        buf[self._fill :] = SEP
        # the FINAL flush (the only partial one — add_codes flushes full
        # buffers) runs at the next power-of-two of the actual fill instead
        # of the full batch shape: sorting an 8M-slot buffer that holds 1M
        # live bases costs the same as a full flush, and result() pays it
        # on the critical path. Power-of-two lengths keep the compiled
        # program set bounded (floor 2^17, always a multiple of 8; the
        # floor is not measured on the H100).
        blen = self._batch
        if self._fill < self._batch:
            blen = min(max(1 << 17, 1 << (self._fill - 1).bit_length()), self._batch)
        packed, bad = pack_codes_host(buf[:blen])
        # the raw sorted batch stream only — merge_sorted_device folds the
        # duplicates while merging (no per-batch RLE/compaction pass)
        b = sort_batch_device(jnp.asarray(packed), jnp.asarray(bad), self.k)
        # sync the PREVIOUS flush while the device starts on this batch:
        # its scalar distinct count confirms capacity and implies the
        # buffer we are about to switch to is no longer read by any program
        prev, self._pending = self._pending, None
        if prev is not None:
            self._sync(prev)
        if self._acc is None:
            self._acc = (
                jnp.full(self._cap, SENTINEL, jnp.uint64),
                jnp.zeros(self._cap, jnp.int64),
            )
        # the previous sync pinned the accumulator's distinct count —
        # merge only its occupied prefix, not the dead SENTINEL tail.
        # POWER-OF-TWO slice lengths: the merge program recompiles per
        # shape, and a fine-grained slice would mean a fresh compile on
        # every flush of a low-coverage stream (floor 2^17, not measured
        # on the H100)
        alen = int(self._acc[0].shape[0])
        m_pad = min(1 << max(0, (max(self._acc_n, 1) - 1).bit_length(), 17), alen)
        ak = self._acc[0][:m_pad] if m_pad < alen else self._acc[0]
        ac = self._acc[1][:m_pad] if m_pad < alen else self._acc[1]
        m = merge_sorted_device(ak, ac, b, self._cap)
        self._pending = (self._acc, b, m, self._cap)
        self._acc = (m[0], m[1])
        self._cur ^= 1
        self._fill = 0
        self._bufs[self._cur][:] = SEP

    def _sync(self, prev):
        acc_prev, b, m, cap = prev
        nd = int(m[2])
        if nd > cap:
            # capacity overflow: the truncated merge is wrong — grow and
            # redo from the kept inputs (both still alive on device)
            while nd > self._cap:
                self._cap *= 2
            m = merge_sorted_device(acc_prev[0], acc_prev[1], b, self._cap)
            self._acc = (m[0], m[1])
            nd = int(m[2])
        self._acc_n = nd

    def result(self):
        from .counting import HISTOGRAM_MAX, CountResult

        self._flush()
        if self._pending is not None:
            self._sync(self._pending)
            self._pending = None
        if self._acc is None:
            return CountResult(
                np.zeros(0, np.uint64), np.zeros(0, np.int64),
                np.zeros(HISTOGRAM_MAX + 1, np.int64), self.k,
            )
        n = self._acc_n
        # slice to a 128K-granular length before the transfer: near-exact
        # data volume with a bounded, cacheable set of slice program shapes
        # (the granularity is not measured on the H100)
        gran = 1 << 17
        n_pad = min(-(-max(n, 1) // gran) * gran, int(self._acc[0].shape[0]))
        # counts ship as clamped u8 + a compacted exception list (count >
        # 255 — empty at any realistic coverage): 1 B/distinct instead of
        # 8. Dispatch the pack first so it computes while the keys
        # transfer blocks.
        c8, eidx, evals, n_exc_d = pack_counts_device(self._acc[1][:n_pad], _EXC_CAP)
        keys = np.asarray(self._acc[0][:n_pad])[:n]
        n_exc = int(n_exc_d)
        if n_exc <= _EXC_CAP:
            counts = np.asarray(c8)[:n].astype(np.int64)
            if n_exc:
                m = min(1 << (n_exc - 1).bit_length(), _EXC_CAP)  # pow2 slice
                ei = np.asarray(eidx[:m])[:n_exc]
                counts[ei] = np.asarray(evals[:m])[:n_exc]
        else:  # more exceptions than the fixed cap: full-width fallback
            counts = np.asarray(self._acc[1][:n_pad])[:n].astype(np.int64)
        hist = np.zeros(HISTOGRAM_MAX + 1, np.int64)
        np.add.at(hist, np.minimum(counts, HISTOGRAM_MAX), 1)
        return CountResult(keys, counts, hist, self.k)


_EXC_CAP = 1 << 15  # fixed exception capacity (count > 255 per distinct kmer)


@partial(jax.jit, static_argnames=("exc_cap",))
def pack_counts_device(counts, exc_cap: int):
    """Pack i64 per-distinct counts for the device->host boundary: clamped
    u8 counts + a compacted (index, value) exception list for entries over
    255, built with the same scatter-free tuple-sort compaction as the RLE
    (exceptions move to the front in index order). Returns (c8 u8[n],
    exc_idx i32[exc_cap], exc_val i64[exc_cap], n_exc i32); n_exc > exc_cap
    means the list is truncated and the caller must fall back to the
    full-width transfer."""
    n = counts.shape[0]
    over = counts > 255
    n_exc = jnp.sum(over.astype(jnp.int32))
    c8 = jnp.minimum(counts, 255).astype(jnp.uint8)
    idx = jnp.arange(n, dtype=jnp.int32)
    _, idx_c, val_c = jax.lax.sort(((~over).astype(jnp.uint8), idx, counts), num_keys=2)
    pad = max(exc_cap - n, 0)
    if pad:
        idx_c = jnp.concatenate([idx_c, jnp.zeros(pad, jnp.int32)])
        val_c = jnp.concatenate([val_c, jnp.zeros(pad, val_c.dtype)])
    return c8, idx_c[:exc_cap], val_c[:exc_cap], n_exc


@partial(jax.jit, static_argnames=("k",))
def sort_batch_device(packed, bad, k: int):
    """Extract + canonicalize + sort one packed batch — NO RLE/compaction:
    the raw sorted stream (SENTINEL for invalid windows) feeds
    merge_sorted_device, which folds duplicates while it merges. Skipping
    the per-batch compaction removes one full tuple-sort per flush."""
    from ..find.scan_device import rolling_kmers_device, unpack_codes_device

    codes = unpack_codes_device(packed, bad)
    fwd, valid = rolling_kmers_device(codes, k)
    return jnp.sort(jnp.where(valid, K.canonical_u64(fwd, k, jnp), SENTINEL))


@partial(jax.jit, static_argnames=("out_cap",))
def merge_sorted_device(acc_keys, acc_counts, batch_sorted, out_cap: int):
    """Merge the distinct accumulator (keys + i64 counts, SENTINEL-padded)
    with a RAW sorted batch stream (duplicates allowed, implied count 1
    per live element): one sort + cumsum + one compaction tuple-sort. Run
    totals come from exclusive-prefix differences of the compacted run
    starts — no gather, no scatter. Returns (keys u64[out_cap], counts
    i64[out_cap], n_distinct i32); n_distinct > out_cap = truncated, the
    caller grows and re-runs from the kept inputs."""
    keys = jnp.concatenate([acc_keys, batch_sorted])
    cnts = jnp.concatenate(
        [acc_counts.astype(jnp.int64), (batch_sorted != SENTINEL).astype(jnp.int64)]
    )
    keys, cnts = jax.lax.sort((keys, cnts), num_keys=1)
    n = keys.shape[0]
    live = keys != SENTINEL
    newrun = jnp.concatenate([jnp.ones(1, bool), keys[1:] != keys[:-1]]) & live
    n_distinct = jnp.sum(newrun.astype(jnp.int32))
    s = jnp.cumsum(cnts)
    sprev = s - cnts           # exclusive prefix (sentinels contribute 0)
    total = s[-1]
    notstart = (~newrun).astype(jnp.uint8)
    idx = jnp.arange(n, dtype=jnp.int32)
    _, _, keys_c, sprev_c = jax.lax.sort((notstart, idx, keys, sprev), num_keys=2)
    nxt = jnp.concatenate([sprev_c[1:], jnp.zeros(1, sprev_c.dtype)])
    j = jnp.arange(n, dtype=jnp.int32)
    csum = jnp.where(j == n_distinct - 1, total - sprev_c, nxt - sprev_c)
    in_prefix = jnp.arange(out_cap, dtype=jnp.int32) < n_distinct
    pad = max(out_cap - n, 0)
    if pad:
        keys_c = jnp.concatenate([keys_c, jnp.full(pad, SENTINEL, keys_c.dtype)])
        csum = jnp.concatenate([csum, jnp.zeros(pad, csum.dtype)])
    keys_out = jnp.where(in_prefix, keys_c[:out_cap], SENTINEL)
    cnts_out = jnp.where(in_prefix, csum[:out_cap], 0)
    return keys_out, cnts_out, n_distinct


@partial(jax.jit, static_argnames=("k",))
def count_batch_device_packed(packed, bad, k: int):
    """count_batch_device over the 2-bit packed upload format
    (find/scan_device.py pack_codes_host): separators/invalid bases ride
    the bad bitmask and unpack back to 255 on device."""
    from ..find.scan_device import unpack_codes_device

    return count_batch_device(unpack_codes_device(packed, bad), k)


@partial(jax.jit, static_argnames=("k",))
def count_batch_device(codes, k: int):
    """One fused device program: extract + canonicalize + sort + run-length
    encode. Returns (keys u64[P], counts i32[P], n_distinct i32) with the
    distinct keys compacted into the first n_distinct slots (SENTINEL
    padding after) — so the host transfers only the distinct prefix, which
    at real read coverage c is ~1/c of the raw k-mer stream.

    The compaction is scatter-free: a second lax.sort with key
    (is_run_start DESC, key ASC) moves run starts (already in key order) to
    the front, carrying their positions; counts are position differences.
    The pass is two sorts plus elementwise work."""
    from ..find.scan_device import rolling_kmers_device

    fwd, valid = rolling_kmers_device(codes, k)
    canon = jnp.where(valid, K.canonical_u64(fwd, k, jnp), SENTINEL)
    s = jnp.sort(canon)
    n = s.shape[0]
    n_valid = jnp.sum((s != SENTINEL).astype(jnp.int32))
    newrun = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]]) & (s != SENTINEL)
    n_distinct = jnp.sum(newrun.astype(jnp.int32))
    # tuple-sort compaction — run starts move to the front already in key
    # order; count of run i = next start position - its own (tail closed by
    # n_valid). Scatter-free by construction (a cumsum+scatter variant is
    # the alternative; not measured on the H100).
    notstart = (~newrun).astype(jnp.uint8)
    pos = jnp.arange(n, dtype=jnp.int32)
    _, keys_c, pos_c = jax.lax.sort((notstart, s, pos), num_keys=2)
    pos_next = jnp.concatenate([pos_c[1:], jnp.zeros(1, jnp.int32)])
    in_prefix = pos < n_distinct
    nxt = jnp.where(pos == n_distinct - 1, n_valid, pos_next)
    counts = jnp.where(in_prefix, nxt - pos_c, 0)
    keys_out = jnp.where(in_prefix, keys_c, SENTINEL)
    return keys_out, counts, n_distinct
