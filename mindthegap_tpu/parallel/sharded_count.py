"""Mesh-sharded k-mer counting — the distributed DSK build wired into the
real pipeline (`-count-engine sharded`).

The reference's SortingCountAlgorithm partitions k-mers by minimizer onto
disk and counts partitions on threads (call site
src/FindBreakpoints.hpp:965-979, config src/Finder.cpp:226-263). The
device restatement (SURVEY.md §2.3 row 1, §5.8): read batches are cut
into per-device chunks on a 1-D mesh; each device extracts + canonicalizes
its k-mers; every k-mer is then ROUTED to its owner device by a bijective
hash prefix via `all_to_all` (NCCL over NVLink on GPUs), so each device owns a disjoint shard
of the key space (the exact-set analog of sharding the Bloom filter). Each
device sorts what it received; the host merges per-owner sorted runs flush
by flush.

Ownership by hash makes the per-owner partial counts *complete*: a given
canonical k-mer lands on the same device in every flush, so the final
per-owner histograms are disjoint and their `psum` across the mesh is the
EXACT global abundance histogram that feeds the `auto` cutoff
(src/Finder.cpp:254-255) — no approximation anywhere; the result is
bit-identical to the host StreamingCounter.

Per flush, on device (shard_map over the mesh axis):
  codes[1, C+k-1] -> rolling canonical k-mers [C]
                  -> swizzle = bijective mix(canon)  (invalid -> MAX)
                  -> sort (swz, canon) pairs
                  -> slice n_dev fixed-capacity owner segments
                  -> all_to_all exchange (ICI)
                  -> re-sort received pairs
Host pulls the per-device sorted (swz, canon) planes, run-length encodes,
and merges into per-owner running (swz, canon, counts) runs.

The swizzle constant is chosen so that mix^{-1}(2^64-1) is not a valid
canonical k-mer for this k — the MAX sentinel can then never collide with a
real key and exactness holds with no corner cases.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1
_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)

# candidate odd multipliers for the swizzle bijection (splitmix64 / xxhash /
# murmur finalizer constants)
_SWZ_CONSTS = (
    0x9E3779B97F4A7C15,
    0xC2B2AE3D27D4EB4F,
    0xFF51AFD7ED558CCD,
    0xC4CEB9FE1A85EC53,
    0xD6E8FEB86659FD93,
)


def _mix_int(x: int, c: int) -> int:
    x = (x ^ (x >> 33)) & _MASK64
    x = (x * c) & _MASK64
    return (x ^ (x >> 29)) & _MASK64


def _inv_xorshift(y: int, s: int) -> int:
    x = y
    while True:
        nx = y ^ (x >> s)
        if nx == x:
            return x
        x = nx


def _mix_inverse(y: int, c: int) -> int:
    y = _inv_xorshift(y, 29)
    y = (y * pow(c, -1, 1 << 64)) & _MASK64
    return _inv_xorshift(y, 33)


def pick_swizzle_const(k: int) -> int:
    """First mix constant whose preimage of 2^64-1 cannot be a canonical
    k-mer (canonical = min(fwd, revcomp), always < revcomp-of-itself when
    fwd is all-G, so specific values are checkable exactly)."""
    from ..ops.span import canonical_int

    for c in _SWZ_CONSTS:
        pre = _mix_inverse(_MASK64, c)
        if pre >= (1 << (2 * k)) or canonical_int(pre, k) != pre:
            return c
    raise AssertionError("no safe swizzle constant for k=%d" % k)


class ShardedStreamingCounter:
    """Drop-in for ops/counting.py StreamingCounter (k <= 32) running the
    per-base work sharded over a device mesh with all_to_all key routing."""

    def __init__(self, k: int, mesh=None, batch_bases: int = 1 << 23, slack: float = 1.10):
        assert k <= 32, "sharded counter: k <= 32 (host counter covers larger spans)"
        import jax

        from . import mesh as M

        self.k = k
        if mesh is None:
            n = len(jax.devices())
            n = 1 << (n.bit_length() - 1)  # largest power of two
            mesh = M.make_mesh(n)
        self.mesh = mesh
        self.n_dev = int(mesh.devices.size)
        assert self.n_dev & (self.n_dev - 1) == 0, "mesh size must be a power of two"
        self.axis = mesh.axis_names[0]
        self._swz_const = pick_swizzle_const(k)

        # per-device chunk of C owned positions (+ k-1 halo bases)
        self._C = max(-(-int(batch_bases) // self.n_dev), 4 * k)
        self._B = self._C * self.n_dev
        assert self._B >= 2 * k
        self._cap = int(self._C / self.n_dev * slack) + 64
        self._buf = np.full(self._B + k - 1, 255, np.uint8)
        self._fill = 0
        # per-owner running runs: (swz sorted, canon, counts)
        self._runs = [
            (np.zeros(0, np.uint64), np.zeros(0, np.uint64), np.zeros(0, np.int64))
            for _ in range(self.n_dev)
        ]
        self._flush_fn = None

    # ------------------------------------------------------------------
    def _build_flush_fn(self):
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..find.scan_device import rolling_kmers_device
        from ..ops import kmers as K

        k = self.k
        n = self.n_dev
        cap = self._cap
        axis = self.axis
        log_n = n.bit_length() - 1
        shift = np.uint64(64 - log_n) if log_n else np.uint64(63)
        const = np.uint64(self._swz_const)

        def shard_fn(codes):  # [1, C + k - 1]
            row = codes[0]
            fwd, valid = rolling_kmers_device(row, k)  # [C]
            canon = K.canonical_u64(fwd, k, jnp)
            swz = (canon ^ (canon >> jnp.uint64(33))) * const
            swz = swz ^ (swz >> jnp.uint64(29))
            swz = jnp.where(valid, swz, _SENTINEL)
            canon = jnp.where(valid, canon, _SENTINEL)
            swz, canon = jax.lax.sort((swz, canon), num_keys=1)

            if log_n:
                bounds = (jnp.arange(1, n, dtype=jnp.uint64)) << shift
                starts = jnp.concatenate(
                    [jnp.zeros(1, jnp.int32), jnp.searchsorted(swz, bounds).astype(jnp.int32)]
                )
            else:
                starts = jnp.zeros(1, jnp.int32)
            end_valid = jnp.searchsorted(swz, _SENTINEL).astype(jnp.int32)
            ends = jnp.concatenate([starts[1:], end_valid[None]])
            ends = jnp.maximum(ends, starts)  # owner n-1's start may exceed end_valid
            overflow = jnp.max(ends - starts) > cap

            idx = starts[:, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
            mask = idx < ends[:, None]
            idx = jnp.minimum(idx, swz.shape[0] - 1)
            send_swz = jnp.where(mask, swz[idx], _SENTINEL)
            send_canon = jnp.where(mask, canon[idx], _SENTINEL)

            recv_swz = jax.lax.all_to_all(send_swz, axis, split_axis=0, concat_axis=0)
            recv_canon = jax.lax.all_to_all(send_canon, axis, split_axis=0, concat_axis=0)

            rs, rc = jax.lax.sort(
                (recv_swz.reshape(-1), recv_canon.reshape(-1)), num_keys=1
            )
            return rs[None, :], rc[None, :], overflow[None]

        mapped = jax.shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(P(axis, None),),
            out_specs=(P(axis, None), P(axis, None), P(axis)),
        )
        jitted = jax.jit(mapped)
        sharding = NamedSharding(self.mesh, P(axis, None))

        def run(chunks: np.ndarray):
            out = jitted(jax.device_put(jnp.asarray(chunks), sharding))
            if jax.process_count() > 1:
                # multi-host: owner shards live on remote processes too
                from jax.experimental import multihost_utils

                return multihost_utils.process_allgather(out, tiled=True)
            return out

        return run

    # ------------------------------------------------------------------
    def add_codes(self, codes: np.ndarray):
        codes = np.asarray(codes, np.uint8)
        pos = 0
        n = codes.size
        B = self._B + self.k - 1
        while True:
            take = min(n - pos, B - self._fill)
            self._buf[self._fill : self._fill + take] = codes[pos : pos + take]
            self._fill += take
            pos += take
            if pos >= n:
                if self._fill < B:
                    self._buf[self._fill] = 255  # read boundary
                    self._fill += 1
                else:
                    self._flush()
                return
            # buffer full mid-read: flush, rewind k-1 so split windows count once
            self._flush()
            pos = max(pos - (self.k - 1), 0)

    def _flush(self):
        if self._fill == 0:
            return
        self._buf[self._fill :] = 255
        if self._flush_fn is None:
            self._flush_fn = self._build_flush_fn()
        # chunk i owns window starts [i*C, (i+1)*C); needs k-1 halo bases
        C, k = self._C, self.k
        chunks = np.empty((self.n_dev, C + k - 1), np.uint8)
        for i in range(self.n_dev):
            chunks[i] = self._buf[i * C : (i + 1) * C + k - 1]
        rs, rc, overflow = self._flush_fn(chunks)
        rs, rc = np.asarray(rs), np.asarray(rc)
        if bool(np.asarray(overflow).any()):  # pragma: no cover - cap is ~50 sigma
            self._flush_host_fallback()
        else:
            for d in range(self.n_dev):
                self._merge_owner(d, rs[d], rc[d])
        self._fill = 0
        self._buf[:] = 255

    def _flush_host_fallback(self):
        """Exact host-side routing of one flush (only on capacity overflow)."""
        from ..ops import kmers as K

        valid_buf = self._buf
        fwd, valid = K.kmers_from_codes(valid_buf, self.k)
        canon = K.canonical_u64(fwd[valid], self.k)
        c = np.uint64(self._swz_const)
        swz = (canon ^ (canon >> np.uint64(33))) * c
        swz = swz ^ (swz >> np.uint64(29))
        order = np.argsort(swz)
        swz, canon = swz[order], canon[order]
        log_n = self.n_dev.bit_length() - 1
        owner = (swz >> np.uint64(64 - log_n)).astype(np.int64) if log_n else np.zeros(swz.size, np.int64)
        for d in range(self.n_dev):
            m = owner == d
            self._merge_owner(d, swz[m], canon[m])

    def _merge_owner(self, d: int, swz: np.ndarray, canon: np.ndarray):
        n_real = int(np.searchsorted(swz, _SENTINEL))
        swz, canon = swz[:n_real], canon[:n_real]
        if swz.size == 0:
            return
        newrun = np.empty(swz.size, bool)
        newrun[0] = True
        newrun[1:] = swz[1:] != swz[:-1]
        idx = np.flatnonzero(newrun)
        u_swz, u_canon = swz[idx], canon[idx]
        u_cnt = np.diff(idx, append=swz.size).astype(np.int64)

        a_swz, a_canon, a_cnt = self._runs[d]
        if a_swz.size == 0:
            self._runs[d] = (u_swz, u_canon, u_cnt)
            return
        m_swz = np.concatenate([a_swz, u_swz])
        m_canon = np.concatenate([a_canon, u_canon])
        m_cnt = np.concatenate([a_cnt, u_cnt])
        order = np.argsort(m_swz, kind="stable")
        m_swz, m_canon, m_cnt = m_swz[order], m_canon[order], m_cnt[order]
        uniq = np.empty(m_swz.size, bool)
        uniq[0] = True
        uniq[1:] = m_swz[1:] != m_swz[:-1]
        gid = np.cumsum(uniq) - 1
        out_cnt = np.zeros(int(gid[-1]) + 1, np.int64)
        np.add.at(out_cnt, gid, m_cnt)
        self._runs[d] = (m_swz[uniq], m_canon[uniq], out_cnt)

    # ------------------------------------------------------------------
    def _psum_histogram(self, hists: np.ndarray) -> np.ndarray:
        """All-reduce the per-owner histograms over the mesh. Owners are
        disjoint key shards, so this psum is the exact global histogram."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis = self.axis

        def f(h):
            return jax.lax.psum(h[0], axis)

        mapped = jax.shard_map(
            f, mesh=self.mesh, in_specs=(P(axis, None),), out_specs=P()
        )
        sharding = NamedSharding(self.mesh, P(axis, None))
        out = jax.jit(mapped)(jax.device_put(jnp.asarray(hists), sharding))
        return np.asarray(out)

    def result(self):
        from ..ops.counting import HISTOGRAM_MAX, CountResult

        self._flush()
        hists = np.zeros((self.n_dev, HISTOGRAM_MAX + 1), np.int64)
        for d in range(self.n_dev):
            cnt = self._runs[d][2]
            np.add.at(hists[d], np.minimum(cnt, HISTOGRAM_MAX), 1)
        hist = self._psum_histogram(hists)

        canon_all = np.concatenate([r[1] for r in self._runs])
        cnt_all = np.concatenate([r[2] for r in self._runs])
        order = np.argsort(canon_all)
        return CountResult(canon_all[order], cnt_all[order], hist, self.k)
