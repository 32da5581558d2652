"""Extension-bitmap membership map — the gather-lean de Bruijn graph probe.

The find scan needs, per reference position i (reference
src/FindBreakpoints.hpp:560-622 + store_kmer_info): membership of kmer_i,
its forward-strand in/out degrees, and two (k-1)-mer repeat bits — naively
11 independent set probes. The layouts below were chosen to minimise the
number of device-memory gathers per position (their cost on the H100 is
not measured), so the structure restates all of it as ~2 gathers per
position:

Key observation: out-neighbors of kmer_i share their (k-1)-prefix
p_{i+1} = kmer_i[1:], in-neighbors share their (k-1)-suffix p_i =
kmer_i[:-1], and kmer_i itself is p_i·x. So index a hash table by
*canonical (k-1)-mers* whose payload is one byte:

    ext[4 bits]  — which bases x make  p·x  a solid k-mer (as-read p)
    pre[4 bits]  — which bases y make  y·p  a solid k-mer (as-read p)

For the reverse-complement orientation the payload is derivable:
ext_{rc(p)}[x] = pre_p[x ^ 2] and pre_{rc(p)}[y] = ext_p[y ^ 2]
(complement is code^2 in the A=0,C=1,T=2,G=3 alphabet), so one canonical
entry serves both strands. Then, per position, ONE lookup at canon(p_i)
yields contains(kmer_{i-1})'s last bit, nb_in(kmer_i), and nb_out(kmer_{i-1});
a sliding window over positions turns the whole plane pass into one lookup
stream. Storage: 2-choice cuckoo (load 0.45), key plane u64 + payload
plane u8, built host-side (exact — no Bloom FPs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import kmers as K

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)

_H1 = np.uint64(0x9E3779B97F4A7C15)
_H2 = np.uint64(0xC2B2AE3D27D4EB4F)


def _mix(keys, const):
    h = (keys ^ (keys >> np.uint64(33))) * const
    return h ^ (h >> np.uint64(29))


@dataclass
class ExtMap:
    keys: np.ndarray  # u64 [S]
    payload: np.ndarray  # u8 [S]
    log_size: int
    stash_keys: np.ndarray  # u64 [<=64]
    stash_payload: np.ndarray  # u8

    @property
    def nbytes(self):
        return self.keys.nbytes + self.payload.nbytes


def build(solid_canonical: np.ndarray, k: int, load_factor: float = 0.35) -> "ExtMap":
    """Build the (k-1)-mer extension map from the canonical solid k-mer set."""
    uniq_keys, payload = _ext_bits(solid_canonical, k)
    return _place(uniq_keys, payload, load_factor)


def _ext_bits(solid_canonical: np.ndarray, k: int):
    """(canonical (k-1)-mer keys, u8 ext/pre payload) for the solid set."""
    solid = np.asarray(solid_canonical, dtype=np.uint64)
    km1 = k - 1
    mask_km1 = K.kmer_mask(km1)
    shift_first = np.uint64(2 * km1)

    # both orientations of every solid kmer
    fwd = solid
    rc = K.revcomp_u64(solid, k)
    allk = np.concatenate([fwd, rc])

    # prefix rule: p = F >> 2 (as-read), x = F & 3  -> ext_p[x]
    p_pref = (allk >> np.uint64(2)) & mask_km1
    x_last = (allk & np.uint64(3)).astype(np.uint8)
    # suffix rule: s = F & mask, y = first base     -> pre_s[y]
    s_suff = allk & mask_km1
    y_first = ((allk >> shift_first) & np.uint64(3)).astype(np.uint8)

    # fold into canonical (k-1)-mer keys; rc keys swap/complement bit roles
    def fold(keys_asread, bitpos, is_ext):
        canon = K.canonical_u64(keys_asread, km1)
        is_canon = keys_asread == canon
        # ext bits live in payload bits 0..3, pre bits in 4..7
        bit = np.where(
            is_canon,
            (0 if is_ext else 4) + bitpos,
            (4 if is_ext else 0) + (bitpos ^ 2),
        )
        return canon, np.left_shift(np.uint8(1), bit.astype(np.uint8)).astype(np.uint16)

    k1, b1 = fold(p_pref, x_last, True)
    k2, b2 = fold(s_suff, y_first, False)
    keys_all = np.concatenate([k1, k2])
    bits_all = np.concatenate([b1, b2]).astype(np.uint8)

    # aggregate payload per distinct key (bitwise or)
    order = np.argsort(keys_all, kind="stable")
    ks, bs = keys_all[order], bits_all[order]
    uniq_mask = np.empty(ks.size, bool)
    uniq_mask[0] = True
    uniq_mask[1:] = ks[1:] != ks[:-1]
    group = np.cumsum(uniq_mask) - 1
    payload = np.zeros(int(group[-1]) + 1, np.uint8)
    np.bitwise_or.at(payload, group, bs)
    uniq_keys = ks[uniq_mask]

    return uniq_keys, payload


def _load_native():
    """Lazy-build/load the native table builder (native/tables.cpp)."""
    global _NATIVE_LIB, _NATIVE_FAILED
    if _NATIVE_LIB is not None or _NATIVE_FAILED:
        return _NATIVE_LIB
    import ctypes

    from ..utils import native_build

    try:
        lib = ctypes.CDLL(native_build.build("tables.cpp"))
        lib.extmap_place.restype = ctypes.c_int64
        lib.extmap_place.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        if hasattr(lib, "extmap_place16"):
            lib.extmap_place16.restype = ctypes.c_int64
            lib.extmap_place16.argtypes = lib.extmap_place.argtypes
        if hasattr(lib, "qmap_build"):
            lib.qmap_build.restype = ctypes.c_int64
            lib.qmap_build.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ]
        if hasattr(lib, "qbmap_build"):
            lib.qbmap_build.restype = ctypes.c_int64
            lib.qbmap_build.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ]
        if hasattr(lib, "qpmap_build"):
            lib.qpmap_build.restype = ctypes.c_int64
            lib.qpmap_build.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ]
        _NATIVE_LIB = lib
    except Exception:
        _NATIVE_FAILED = True
        _NATIVE_LIB = None
    return _NATIVE_LIB


_NATIVE_LIB = None
_NATIVE_FAILED = False


def _place_native(keys: np.ndarray, values: np.ndarray, log_size: int):
    import ctypes

    lib = _load_native()
    if lib is None:
        return None
    vdt = values.dtype
    if vdt == np.uint8:
        fn = lib.extmap_place
    elif vdt == np.uint16:
        fn = getattr(lib, "extmap_place16", None)
        if fn is None:
            return None
    else:
        return None  # u32+ payloads (row indices): numpy placement only
    size = 1 << log_size
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    values = np.ascontiguousarray(values)
    table = np.full(size, EMPTY, np.uint64)
    payload = np.zeros(size, vdt)
    scratch = np.zeros(size, np.uint8)
    stash_k = np.zeros(64, np.uint64)
    stash_v = np.zeros(64, vdt)
    n_stash = fn(
        keys.ctypes.data_as(ctypes.c_void_p), values.ctypes.data_as(ctypes.c_void_p),
        keys.size, log_size,
        table.ctypes.data_as(ctypes.c_void_p), payload.ctypes.data_as(ctypes.c_void_p),
        scratch.ctypes.data_as(ctypes.c_void_p),
        stash_k.ctypes.data_as(ctypes.c_void_p), stash_v.ctypes.data_as(ctypes.c_void_p), 64,
    )
    if n_stash < 0:
        return None
    order = np.argsort(stash_k[:n_stash])
    return ExtMap(table, payload, log_size, stash_k[:n_stash][order], stash_v[:n_stash][order])


def _place(keys: np.ndarray, values: np.ndarray, load_factor: float, min_log: int = 4) -> "ExtMap":
    n = max(int(keys.size), 1)
    log_size = max(min_log, int(np.ceil(np.log2(n / load_factor))))
    if keys.size:
        em = _place_native(keys, values, log_size)
        if em is not None:
            return em
    size = 1 << log_size
    tab_k = np.full(size, EMPTY, np.uint64)
    tab_v = np.zeros(size, values.dtype)
    choice = np.zeros(size, np.uint8)

    pend_k, pend_v = keys, values
    ptry = np.zeros(pend_k.size, np.uint8)
    attempts = np.zeros(pend_k.size, np.uint8)
    consts = (_H1, _H2)

    for rnd in range(300):
        if pend_k.size == 0:
            break
        slots = np.empty(pend_k.size, np.int64)
        for h in range(2):
            m = ptry == h
            if m.any():
                slots[m] = (_mix(pend_k[m], consts[h]) >> np.uint64(64 - log_size)).astype(np.int64)
        force = attempts >= 2
        greedy = ~force & (tab_k[slots] == EMPTY)
        gidx = np.nonzero(greedy)[0]
        u, fi = np.unique(slots[gidx], return_index=True)
        tab_k[u] = pend_k[gidx[fi]]
        tab_v[u] = pend_v[gidx[fi]]
        choice[u] = ptry[gidx[fi]]
        placed = np.zeros(pend_k.size, bool)
        placed[gidx[fi]] = True

        ev_k = np.zeros(0, np.uint64)
        ev_v = np.zeros(0, values.dtype)
        ev_t = np.zeros(0, np.uint8)
        fidx = np.nonzero(force)[0]
        if fidx.size:
            # stagger evictions (random ~25% per round, varying by round) to
            # break symmetric eviction cycles between parallel force keys
            gate = ((_mix(pend_k[fidx], np.uint64(0xA0761D6478BD642F + 2 * rnd + 1)) >> np.uint64(62)) == 0)
            fidx = fidx[gate]
        if fidx.size:
            u, fi = np.unique(slots[fidx], return_index=True)
            occ = tab_k[u] != EMPTY
            ev_k, ev_v = tab_k[u][occ], tab_v[u][occ]
            ev_t = (choice[u][occ] + 1) % 2
            tab_k[u] = pend_k[fidx[fi]]
            tab_v[u] = pend_v[fidx[fi]]
            choice[u] = ptry[fidx[fi]]
            placed[fidx[fi]] = True

        rest = ~placed
        pend_k = np.concatenate([pend_k[rest], ev_k])
        pend_v = np.concatenate([pend_v[rest], ev_v])
        ptry = np.concatenate([(ptry[rest] + 1) % 2, ev_t])
        attempts = np.concatenate([attempts[rest] + 1, np.zeros(ev_k.size, np.uint8)])

    # sequential random-walk cleanup
    rng = np.random.default_rng(0xBEEF)
    stuck_k, stuck_v = [], []
    for key, val in zip(pend_k, pend_v):
        cur_k, cur_v = np.uint64(key), values.dtype.type(val)
        ch = 0
        ok = False
        for _ in range(500):
            slot = int(_mix(cur_k[None], consts[ch])[0] >> np.uint64(64 - log_size))
            if tab_k[slot] == EMPTY:
                tab_k[slot], tab_v[slot], choice[slot] = cur_k, cur_v, ch
                ok = True
                break
            cur_k, tab_k[slot] = tab_k[slot], cur_k
            cur_v, tab_v[slot] = tab_v[slot], cur_v
            oc = int(choice[slot])
            choice[slot] = ch
            ch = (oc + 1) % 2
        if not ok:
            stuck_k.append(int(cur_k))
            stuck_v.append(int(cur_v))
    if len(stuck_k) > 64:
        raise ValueError(f"extmap build left {len(stuck_k)} keys unplaced")
    order = np.argsort(np.array(stuck_k, np.uint64))
    return ExtMap(
        tab_k, tab_v, log_size,
        np.array(stuck_k, np.uint64)[order],
        np.array(stuck_v, values.dtype)[order],
    )


def lookup_payload(em: ExtMap, canon_keys, xp=np):
    """Vectorized payload lookup (0 for absent keys). 4 gathers total plus a
    tiny binary search when a stash exists."""
    keys = xp.asarray(canon_keys, dtype=xp.uint64)
    out = xp.zeros(keys.shape, dtype=xp.uint8)
    for const in (_H1, _H2):
        h = (keys ^ (keys >> np.uint64(33))) * const
        h = h ^ (h >> np.uint64(29))
        slots = (h >> np.uint64(64 - em.log_size)).astype(xp.int64 if xp is not np else np.int64)
        hit = em.keys[slots] == keys
        out = xp.where(hit, em.payload[slots], out)
    n_stash = int(em.stash_keys.shape[0])
    if n_stash:
        idx = xp.minimum(xp.searchsorted(em.stash_keys, keys), n_stash - 1)
        hit = em.stash_keys[idx] == keys
        out = xp.where(hit, em.stash_payload[idx], out)
    return out


def build_member(keys_canonical: np.ndarray, load_factor: float = 0.35) -> "ExtMap":
    """Key-only membership table (2-choice cuckoo, 2 gathers per probe)."""
    keys = np.unique(np.asarray(keys_canonical, dtype=np.uint64))
    return _place(keys, np.ones(keys.size, np.uint8), load_factor)


def lookup_member(em: ExtMap, canon_keys, xp=np):
    """Vectorized key-only membership. 2 gathers total plus a tiny binary
    search when a stash exists."""
    keys = xp.asarray(canon_keys, dtype=xp.uint64)
    found = xp.zeros(keys.shape, dtype=bool)
    for const in (_H1, _H2):
        h = (keys ^ (keys >> np.uint64(33))) * const
        h = h ^ (h >> np.uint64(29))
        slots = (h >> np.uint64(64 - em.log_size)).astype(xp.int64 if xp is not np else np.int64)
        found = found | (em.keys[slots] == keys)
    n_stash = int(em.stash_keys.shape[0])
    if n_stash:
        idx = xp.minimum(xp.searchsorted(em.stash_keys, keys), n_stash - 1)
        found = found | (em.stash_keys[idx] == keys)
    return found


def planes_from_payload(payload_i, payload_i1, strand_i, strand_i1, last_base_i, xp=np):
    """Derive (contains_i, nb_in_i, nb_out_i) from the payloads of
    q_i = kmer_i[0:k-1] and q_{i+1} = kmer_i[1:k]:

      contains(kmer_i) = ext_{q_i}[last base of kmer_i]
      nb_out(kmer_i)   = popcount(ext_{q_{i+1}})
      nb_in(kmer_i)    = popcount(pre_{q_i})

    strand_*: True where the as-read (k-1)-mer equals its canonical form.
    last_base_i: kmer_i's last base code (= base at position i+k-1)."""
    ext_i, pre_i = _oriented(payload_i, strand_i, xp)
    ext_i1, _ = _oriented(payload_i1, strand_i1, xp)
    contains = ((ext_i >> last_base_i) & 1).astype(bool)
    nb_out = _popcount4(ext_i1, xp)
    nb_in = _popcount4(pre_i, xp)
    return contains, nb_in, nb_out


def _oriented(payload, is_canon, xp):
    ext_c = payload & 0x0F
    pre_c = (payload >> 4) & 0x0F
    # rc orientation: ext'[x] = pre_c[x^2] ; bit shuffle 0<->2, 1<->3
    ext_rc = _shuffle02(pre_c, xp)
    pre_rc = _shuffle02(ext_c, xp)
    ext = xp.where(is_canon, ext_c, ext_rc)
    pre = xp.where(is_canon, pre_c, pre_rc)
    return ext, pre


def _shuffle02(bits, xp):
    """Permute bitmap positions b -> b^2 (swap bits 0<->2 and 1<->3)."""
    b0 = (bits >> 0) & 1
    b1 = (bits >> 1) & 1
    b2 = (bits >> 2) & 1
    b3 = (bits >> 3) & 1
    return (b2 << 0) | (b3 << 1) | (b0 << 2) | (b1 << 3)


def _popcount4(bits, xp):
    return (((bits >> 0) & 1) + ((bits >> 1) & 1) + ((bits >> 2) & 1) + ((bits >> 3) & 1)).astype(
        xp.int32
    )


# ---------------------------------------------------------------------------
# Fused quotient map — the 2-gather-per-position find-scan structure.
#
# The ext map above needs 4 gathers per lookup (2 cuckoo probes x key+payload
# planes) plus 2 more for the separate (k-1)-mer repeat set: 6 gathers per
# reference base. Two observations remove 2/3 of them:
#
#  1. The cuckoo hash `mix` is a bijection on u64 (xorshift and odd-multiply
#     steps are each invertible), so a slot need not store the key: the slot
#     index pins the top `log_size` bits of h = mix(key), and storing the
#     remaining 64-log_size bits ("remainder") plus which hash function
#     placed the entry identifies the key EXACTLY (no fingerprint FPs).
#     Key plane and payload plane collapse into one u64 slot:
#
#         [ rem : 64-log_size ][ valid:1 ][ hash-choice:1 ][ payload:9 ]
#          bit 11+               bit 10     bit 9            bits 0-8
#
#  2. The repeat set is keyed by the same canonical (k-1)-mers as the ext
#     map, so its bit rides in the payload (bit 8) of a union table.
#
# One lookup = 2 independent u64 gathers; per reference position the whole
# find plane set (contains, nb_in, nb_out, suffix/prefix repeat) costs ~2
# gathers. Requires log_size >= 11 (rem <= 53 bits); build forces >= 12.
"""Reference semantics covered: src/FindBreakpoints.hpp:560-622 (membership +
degrees per scanned k-mer) and :1012-1046 (two (k-1)-mer repeat-bloom
queries per position), restated as one fused exact-map lookup stream."""

QPAY_MASK = np.uint64(0x1FF)  # payload bits 0..8
QREP_BIT = np.uint16(1 << 8)  # repeat flag inside the payload
_QSHIFT_PAY = np.uint64(11)
_QVALID = np.uint64(1 << 10)
_QCHOICE = np.uint64(1 << 9)


@dataclass
class QMap:
    slots: np.ndarray  # u64 [2**log_size]; 0 = empty
    log_size: int
    stash_keys: np.ndarray  # u64 [<=64] (EMPTY-padded never matches)
    stash_payload: np.ndarray  # u16

    @property
    def nbytes(self):
        return self.slots.nbytes


def build_fused(
    solid_canonical: np.ndarray,
    k: int,
    repeat_canonical: np.ndarray,
    load_factor: float = 0.35,
) -> "QMap":
    """Union table over canonical (k-1)-mers: ext/pre bitmap (bits 0-7) from
    the solid k-mer set + repeat bit (bit 8) from the reference repeat set."""
    if k <= 32:
        qm = _build_fused_native(solid_canonical, k, repeat_canonical, load_factor)
        if qm is not None:
            return qm
    ext_keys, ext_pay = _ext_bits(solid_canonical, k)
    rep_keys = np.unique(np.asarray(repeat_canonical, dtype=np.uint64))

    keys_all = np.concatenate([ext_keys, rep_keys])
    vals_all = np.concatenate(
        [ext_pay.astype(np.uint16), np.full(rep_keys.size, QREP_BIT, np.uint16)]
    )
    order = np.argsort(keys_all, kind="stable")
    ks, vs = keys_all[order], vals_all[order]
    uniq = np.empty(ks.size, bool)
    if ks.size:
        uniq[0] = True
        uniq[1:] = ks[1:] != ks[:-1]
        group = np.cumsum(uniq) - 1
        merged = np.zeros(int(group[-1]) + 1, np.uint16)
        np.bitwise_or.at(merged, group, vs)
        keys, vals = ks[uniq], merged
    else:
        keys, vals = ks, vs

    em = _place(keys, vals, load_factor, min_log=12)
    slots = _quotient_encode(em.keys, em.payload, em.log_size)
    stash_k = em.stash_keys
    stash_v = em.stash_payload.astype(np.uint16)
    if stash_k.size == 0:
        stash_k = np.array([EMPTY], np.uint64)
        stash_v = np.zeros(1, np.uint16)
    return QMap(slots, em.log_size, stash_k, stash_v)


def _build_fused_native(solid, k, repeat, load_factor):
    """One-pass native build (native/tables.cpp qmap_build): derive ext bits,
    upsert-with-or into the cuckoo table, quotient-encode. Returns None when
    the native library is unavailable (numpy fallback takes over)."""
    import ctypes

    lib = _load_native()
    if lib is None or not hasattr(lib, "qmap_build"):
        return None
    solid = np.ascontiguousarray(solid, dtype=np.uint64)
    repeat = np.ascontiguousarray(np.unique(np.asarray(repeat, dtype=np.uint64)))
    # distinct (k-1)-mer keys are ~|solid| in practice; start there and grow
    # on placement failure
    n_est = max(int(solid.size) + int(repeat.size), 4)
    log_size = max(12, int(np.ceil(np.log2(n_est / load_factor))))
    for _ in range(6):
        size = 1 << log_size
        tab_k = np.full(size, EMPTY, np.uint64)
        tab_v = np.zeros(size, np.uint16)
        tab_c = np.zeros(size, np.uint8)
        slots = np.zeros(size, np.uint64)
        stash_k = np.zeros(64, np.uint64)
        stash_v = np.zeros(64, np.uint16)
        n_stash = lib.qmap_build(
            solid.ctypes.data_as(ctypes.c_void_p), solid.size, k,
            repeat.ctypes.data_as(ctypes.c_void_p), repeat.size, log_size,
            tab_k.ctypes.data_as(ctypes.c_void_p), tab_v.ctypes.data_as(ctypes.c_void_p),
            tab_c.ctypes.data_as(ctypes.c_void_p),
            slots.ctypes.data_as(ctypes.c_void_p),
            stash_k.ctypes.data_as(ctypes.c_void_p), stash_v.ctypes.data_as(ctypes.c_void_p), 64,
        )
        if n_stash >= 0:
            order = np.argsort(stash_k[:n_stash])
            sk = stash_k[:n_stash][order]
            sv = stash_v[:n_stash][order]
            if sk.size == 0:
                sk = np.array([EMPTY], np.uint64)
                sv = np.zeros(1, np.uint16)
            return QMap(slots, log_size, sk, sv)
        log_size += 1
    return None


def _quotient_encode(tab_keys: np.ndarray, tab_vals: np.ndarray, log_size: int) -> np.ndarray:
    """Pack an explicit (key, payload) cuckoo table into quotient slots.

    The hash choice per slot is recovered from the keys themselves: a key
    sits either at its H1 or its H2 slot (when both coincide, H1 works)."""
    shift = np.uint64(64 - log_size)
    occ = tab_keys != EMPTY
    sidx = np.arange(tab_keys.size, dtype=np.uint64)
    h1 = _mix(tab_keys, _H1)
    h2 = _mix(tab_keys, _H2)
    use1 = (h1 >> shift) == sidx
    ok = use1 | ((h2 >> shift) == sidx)
    if not ok[occ].all():
        raise AssertionError("quotient encode: slot not reachable by either hash")
    h = np.where(use1, h1, h2)
    rem_mask = (np.uint64(1) << shift) - np.uint64(1)
    val = (
        ((h & rem_mask) << _QSHIFT_PAY)
        | _QVALID
        | np.where(use1, np.uint64(0), _QCHOICE)
        | tab_vals.astype(np.uint64)
    )
    return np.where(occ, val, np.uint64(0))


# ---------------------------------------------------------------------------
# Multi-word (k > 32) fused quotient map. Keys are canonical (k-1)-mers of
# Wq = ceil((k-1)/32) uint64 words. Exactness via a 64-bit residual digest:
#
#   key64 = w0 ^ G(w1..w_{Wq-1})        (ops/span_device.py digest64)
#
# The quotient slot pins mix(key64 ^ salt) fully (invertible), and satellite
# planes store words 1..Wq-1 raw; equal digest + equal satellites => equal
# key (w0 recovered by xor). Per probe: 1 slot gather + (Wq-1) satellite
# gathers. `salt` guarantees no salted digest equals the EMPTY sentinel
# (digests span the full u64 range, unlike k <= 32 canonical kmers).


@dataclass
class QMapSpan:
    slots: np.ndarray  # u64 [S]; 0 = empty
    sat: np.ndarray  # u64 [Wq-1, S] satellite word planes
    log_size: int
    salt: int
    stash_key64: np.ndarray  # u64 [n] (salted digests; EMPTY-padded)
    stash_sat: np.ndarray  # u64 [n, Wq-1]
    stash_payload: np.ndarray  # u16 [n]

    @property
    def nbytes(self):
        return self.slots.nbytes + self.sat.nbytes


def build_fused_span(solid_rows: np.ndarray, k: int, repeat_rows: np.ndarray,
                     load_factor: float = 0.35) -> "QMapSpan":
    """Fused (k-1)-mer map for k > 32: ext/pre bits from the multi-word solid
    set + repeat bit, quotient-encoded with satellite word planes."""
    from .span import Span
    from .span_device import digest64

    sp = Span(k)
    spm1 = Span(k - 1)
    wq = spm1.W
    solid_rows = np.asarray(solid_rows, np.uint64).reshape(-1, sp.W)
    repeat_rows = np.asarray(repeat_rows, np.uint64).reshape(-1, wq)

    rows_parts, bits_parts = [], []
    fwd = solid_rows
    orientations = (fwd, sp.revcomp(fwd)) if fwd.size else (fwd,)
    for F in orientations:
        if F.shape[0] == 0:
            continue
        # prefix rule: p = (F >> 2) & mask(k-1), x = last base -> ext_p[x]
        p = sp.low_bits(sp.shifted_right2(F), k - 1)
        x = (F[:, -1] & np.uint64(3)).astype(np.uint8)
        cp = spm1.canonical(p)
        is_c = spm1.keys(p) == spm1.keys(cp)
        bit = np.where(is_c, x, 4 + (x ^ 2))
        rows_parts.append(cp)
        bits_parts.append(np.left_shift(np.uint16(1), bit.astype(np.uint16)).astype(np.uint16))
        # suffix rule: s = F & mask(k-1), y = first base -> pre_s[y]
        s = sp.low_bits(F, k - 1)
        top_bits = 2 * k - 64 * (sp.W - 1)
        y = ((F[:, 0] >> np.uint64(top_bits - 2)) & np.uint64(3)).astype(np.uint8)
        cs = spm1.canonical(s)
        is_cs = spm1.keys(s) == spm1.keys(cs)
        bit = np.where(is_cs, 4 + y, (y ^ 2))
        rows_parts.append(cs)
        bits_parts.append(np.left_shift(np.uint16(1), bit.astype(np.uint16)).astype(np.uint16))
    if repeat_rows.shape[0]:
        rows_parts.append(repeat_rows)
        bits_parts.append(np.full(repeat_rows.shape[0], QREP_BIT, np.uint16))

    if rows_parts:
        rows_all = np.concatenate(rows_parts)
        bits_all = np.concatenate(bits_parts)
    else:
        rows_all = np.zeros((0, wq), np.uint64)
        bits_all = np.zeros(0, np.uint16)

    # dedup by void keys, OR the payload bits
    keys_v = spm1.keys(rows_all)
    order = np.argsort(keys_v, kind="stable")
    kv, bv = keys_v[order], bits_all[order]
    uniq = np.empty(kv.size, bool)
    if kv.size:
        uniq[0] = True
        uniq[1:] = kv[1:] != kv[:-1]
        group = np.cumsum(uniq) - 1
        merged = np.zeros(int(group[-1]) + 1, np.uint16)
        np.bitwise_or.at(merged, group, bv)
        rows = spm1.from_keys(kv[uniq])
        vals = merged
    else:
        rows = rows_all
        vals = bits_all

    dig = digest64(rows.T, xp=np) if rows.shape[0] else np.zeros(0, np.uint64)
    salt = np.uint64(0)
    rng = np.random.default_rng(0xD1CE)
    while rows.shape[0] and bool(((dig ^ salt) == EMPTY).any()):
        salt = np.uint64(rng.integers(0, 1 << 63, dtype=np.uint64))
    dig_s = dig ^ salt

    em = _place(dig_s, np.arange(max(rows.shape[0], 1), dtype=np.uint32)[: rows.shape[0]]
                if rows.shape[0] else np.zeros(0, np.uint32),
                load_factor, min_log=12)
    size = 1 << em.log_size
    occ = em.keys != EMPTY
    idx = em.payload.astype(np.int64)
    pay_slot = np.where(occ, vals[np.minimum(idx, max(vals.size - 1, 0))] if vals.size else 0, 0).astype(np.uint16)
    slots = _quotient_encode(em.keys, pay_slot, em.log_size)
    sat = np.zeros((wq - 1, size), np.uint64)
    if rows.shape[0]:
        occ_idx = np.nonzero(occ)[0]
        for i in range(1, wq):
            sat[i - 1, occ_idx] = rows[idx[occ_idx], i]

    n_st = em.stash_keys.size
    stash_key64 = em.stash_keys if n_st else np.array([EMPTY], np.uint64)
    if n_st:
        sidx = em.stash_payload.astype(np.int64)
        stash_sat = rows[sidx][:, 1:] if wq > 1 else np.zeros((n_st, 0), np.uint64)
        stash_pay = vals[sidx].astype(np.uint16)
    else:
        stash_sat = np.zeros((1, wq - 1), np.uint64)
        stash_pay = np.zeros(1, np.uint16)
    return QMapSpan(slots, sat, em.log_size, int(salt), stash_key64, stash_sat, stash_pay)


def lookup_q_span(qms: QMapSpan, words, xp=np):
    """Fused payload lookup for multi-word keys: per probe 1 slot gather +
    Wq-1 satellite gathers. words: (Wq, P) u64. Returns u16 payload."""
    from .span_device import digest64

    wq = int(words.shape[0])
    shift = np.uint64(64 - qms.log_size)
    rem_mask = (np.uint64(1) << shift) - np.uint64(1)
    dig = digest64(words, xp=xp) ^ np.uint64(qms.salt)
    out = xp.zeros(words.shape[1:], dtype=xp.uint16)
    for i, const in enumerate((_H1, _H2)):
        h = (dig ^ (dig >> np.uint64(33))) * const
        h = h ^ (h >> np.uint64(29))
        slot = (h >> shift).astype(xp.int32)
        v = qms.slots[slot]
        hit = (
            ((v >> _QSHIFT_PAY) == (h & rem_mask))
            & ((v & _QVALID) != 0)
            & (((v & _QCHOICE) != 0) == (i == 1))
        )
        for j in range(1, wq):
            hit = hit & (qms.sat[j - 1][slot] == words[j])
        out = xp.where(hit, (v & QPAY_MASK).astype(xp.uint16), out)
    if int(qms.stash_key64.shape[0]):
        eq = dig[:, None] == qms.stash_key64[None, :]
        for j in range(1, wq):
            eq = eq & (words[j][:, None] == qms.stash_sat[None, :, j - 1])
        add = xp.sum(
            xp.where(eq, qms.stash_payload[None, :], xp.zeros((), xp.uint16)).astype(xp.uint16),
            axis=1,
        ).astype(xp.uint16)
        out = out | add
    return out


def lookup_q(qm: QMap, canon_keys, xp=np):
    """Fused payload lookup: 2 u64 gathers (+ tiny stash pass). Returns u16
    payload (0 for absent keys): ext bits 0-3, pre bits 4-7, repeat bit 8."""
    keys = xp.asarray(canon_keys, dtype=xp.uint64)
    shift = np.uint64(64 - qm.log_size)
    rem_mask = (np.uint64(1) << shift) - np.uint64(1)
    out = xp.zeros(keys.shape, dtype=xp.uint16)
    for i, const in enumerate((_H1, _H2)):
        h = (keys ^ (keys >> np.uint64(33))) * const
        h = h ^ (h >> np.uint64(29))
        slot = (h >> shift).astype(xp.int32)
        v = qm.slots[slot]
        hit = (
            ((v >> _QSHIFT_PAY) == (h & rem_mask))
            & ((v & _QVALID) != 0)
            & (((v & _QCHOICE) != 0) == (i == 1))
        )
        out = xp.where(hit, (v & QPAY_MASK).astype(xp.uint16), out)
    # stash pass (<=64 entries, EMPTY-padded sentinels never match a real
    # (k-1)-mer key since canonical kmers are < 2^62): broadcast-compare,
    # which measures far cheaper than gathers at this width
    if int(qm.stash_keys.shape[0]):
        eq = keys[:, None] == qm.stash_keys[None, :]
        add = xp.sum(
            xp.where(eq, qm.stash_payload[None, :], xp.zeros((), xp.uint16)).astype(xp.uint16),
            axis=1,
        ).astype(xp.uint16)
        out = out | add
    return out


# ---------------------------------------------------------------------------
# Single-probe bucketized quotient map ("QMapB") — 1 HBM gather per position.
#
# Replaces the QMap's 2 independent u64 probes with ONE 16-slot bucket slice
# (128 B, contiguous) per lookup — one wide row gather in place of two
# narrow ones (which is faster on the H100 is not measured):
#
#   h = mix(key)                      (bijective, invertible)
#   bucket = h >> (64 - log_nb)       (top bits)
#   rem    = h & ((1<<(64-log_nb))-1) (the rest — slot pins it exactly)
#   slot   = [rem : 54][valid:1][payload:9]   (requires log_nb >= 10)
#
# Keys whose bucket holds >16 entries go to the <=64-entry stash (mean load
# is sized ~4/bucket; Poisson tail P(>16) ~ 1e-6). Exact — no fingerprints.

_QB_SLOTS = 16
_QB_SHIFT_PAY = np.uint64(10)
_QB_VALID = np.uint64(1 << 9)


@dataclass
class QMapB:
    slots: np.ndarray  # u64 [NB * 16]; 0 = empty
    log_nb: int
    stash_keys: np.ndarray  # u64 (EMPTY-padded)
    stash_payload: np.ndarray  # u16

    @property
    def nbytes(self):
        return self.slots.nbytes


def _fused_entries(solid_canonical, k, repeat_canonical):
    """(keys, u16 payloads) of the fused (k-1)-mer table (shared by the
    cuckoo QMap and the bucketized QMapB builders)."""
    ext_keys, ext_pay = _ext_bits(solid_canonical, k)
    rep_keys = np.unique(np.asarray(repeat_canonical, dtype=np.uint64))
    keys_all = np.concatenate([ext_keys, rep_keys])
    vals_all = np.concatenate(
        [ext_pay.astype(np.uint16), np.full(rep_keys.size, QREP_BIT, np.uint16)]
    )
    order = np.argsort(keys_all, kind="stable")
    ks, vs = keys_all[order], vals_all[order]
    if ks.size == 0:
        return ks, vs
    uniq = np.empty(ks.size, bool)
    uniq[0] = True
    uniq[1:] = ks[1:] != ks[:-1]
    group = np.cumsum(uniq) - 1
    merged = np.zeros(int(group[-1]) + 1, np.uint16)
    np.bitwise_or.at(merged, group, vs)
    return ks[uniq], merged


def build_fused_bucket(
    solid_canonical: np.ndarray,
    k: int,
    repeat_canonical: np.ndarray,
    mean_load: float = 4.0,
) -> "QMapB":
    """Bucketized union table over canonical (k-1)-mers (payload semantics
    identical to build_fused): ext/pre bits 0-7 + repeat bit 8."""
    if k <= 32:
        qb = _build_fused_bucket_native(solid_canonical, k, repeat_canonical, mean_load)
        if qb is not None:
            return qb
    keys, vals = _fused_entries(solid_canonical, k, repeat_canonical)
    n = max(int(keys.size), 1)
    log_nb = max(10, int(np.ceil(np.log2(n / (mean_load * 1.0)))))
    nb = 1 << log_nb
    shift = np.uint64(64 - log_nb)

    h = _mix(keys, _H1)
    bucket = (h >> shift).astype(np.int64)
    rem = h & ((np.uint64(1) << shift) - np.uint64(1))

    order = np.argsort(bucket, kind="stable")
    bucket_s, rem_s, vals_s = bucket[order], rem[order], vals[order]
    # rank within bucket
    counts = np.bincount(bucket_s, minlength=nb)
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(bucket_s.size, dtype=np.int64) - starts[bucket_s]

    slots = np.zeros(nb * _QB_SLOTS, np.uint64)
    fits = rank < _QB_SLOTS
    idx = bucket_s[fits] * _QB_SLOTS + rank[fits]
    slots[idx] = (rem_s[fits] << _QB_SHIFT_PAY) | _QB_VALID | vals_s[fits].astype(np.uint64)

    over = ~fits
    n_over = int(over.sum())
    if n_over > 64:
        raise ValueError(f"bucket map: {n_over} overflow keys (> stash); lower mean_load")
    stash_k = keys[order][over]
    stash_v = vals_s[over]
    if stash_k.size == 0:
        stash_k = np.array([EMPTY], np.uint64)
        stash_v = np.zeros(1, np.uint16)
    else:
        so = np.argsort(stash_k)
        stash_k, stash_v = stash_k[so], stash_v[so]
    return QMapB(slots, log_nb, stash_k, stash_v)


def _build_fused_bucket_native(solid, k, repeat, mean_load):
    """One-pass native build (native/tables.cpp qbmap_build). Returns None
    when the native library is unavailable (numpy fallback takes over)."""
    import ctypes

    lib = _load_native()
    if lib is None or not hasattr(lib, "qbmap_build"):
        return None
    solid = np.ascontiguousarray(solid, dtype=np.uint64)
    repeat = np.ascontiguousarray(np.unique(np.asarray(repeat, dtype=np.uint64)))
    # distinct (k-1)-mer keys ~= |solid| when the solid set comes from
    # sliding windows (each prefix is the previous kmer's suffix); start
    # there — a failed placement (stash overflow) retries with a doubled
    # table, covering pathological sets approaching 2|solid| keys
    n_est = max(int(solid.size) + int(repeat.size), 4)
    log_nb = max(10, int(np.ceil(np.log2(n_est / mean_load))))
    for _ in range(4):
        slots = np.zeros((1 << log_nb) * _QB_SLOTS, np.uint64)
        stash_k = np.zeros(64, np.uint64)
        stash_v = np.zeros(64, np.uint16)
        n_stash = lib.qbmap_build(
            solid.ctypes.data_as(ctypes.c_void_p), solid.size, k,
            repeat.ctypes.data_as(ctypes.c_void_p), repeat.size, log_nb,
            slots.ctypes.data_as(ctypes.c_void_p),
            stash_k.ctypes.data_as(ctypes.c_void_p),
            stash_v.ctypes.data_as(ctypes.c_void_p), 64,
        )
        if n_stash >= 0:
            order = np.argsort(stash_k[:n_stash])
            sk = stash_k[:n_stash][order]
            sv = stash_v[:n_stash][order]
            if sk.size == 0:
                sk = np.array([EMPTY], np.uint64)
                sv = np.zeros(1, np.uint16)
            return QMapB(slots, log_nb, sk, sv)
        log_nb += 1
    return None


def lookup_qb_chunked(qm: QMapB, canon_keys, chunk: int = 1 << 18):
    """lookup_qb in lax.map chunks: a monolithic [P, 16] bucket gather at
    P ~ 2^24 materialises a multi-GB temporary; chunking caps it at
    ~chunk * 128 B."""
    import jax
    import jax.numpy as jnp

    p = canon_keys.shape[0]
    if p <= chunk:
        return lookup_qb(qm, canon_keys, xp=jnp)
    pad = (-p) % chunk
    keys_p = jnp.pad(canon_keys, (0, pad))
    out = jax.lax.map(
        lambda kk: lookup_qb(qm, kk, xp=jnp), keys_p.reshape(-1, chunk)
    )
    return out.reshape(-1)[:p]


def lookup_qb(qm: QMapB, canon_keys, xp=np):
    """Fused payload lookup: ONE 16-slot bucket gather (+ tiny stash pass).
    Returns u16 payload (0 for absent keys)."""
    keys = xp.asarray(canon_keys, dtype=xp.uint64)
    shift = np.uint64(64 - qm.log_nb)
    rem_mask = (np.uint64(1) << shift) - np.uint64(1)
    h = (keys ^ (keys >> np.uint64(33))) * _H1
    h = h ^ (h >> np.uint64(29))
    rem = h & rem_mask
    if xp is np:
        start = ((h >> shift) * np.uint64(_QB_SLOTS)).astype(np.int64)
        rows = qm.slots[start[:, None] + np.arange(_QB_SLOTS)]
    else:
        import jax

        start = ((h >> shift) * np.uint64(_QB_SLOTS)).astype(xp.int64)
        dn = jax.lax.GatherDimensionNumbers(
            offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,)
        )
        rows = jax.lax.gather(
            qm.slots, start[:, None], dn, slice_sizes=(_QB_SLOTS,)
        )
    hit = ((rows >> _QB_SHIFT_PAY) == rem[:, None]) & ((rows & _QB_VALID) != 0)
    pay = xp.where(hit, rows & QPAY_MASK, xp.zeros((), xp.uint64))
    out = xp.max(pay, axis=1).astype(xp.uint16)
    if int(qm.stash_keys.shape[0]):
        eq = keys[:, None] == qm.stash_keys[None, :]
        add = xp.sum(
            xp.where(eq, qm.stash_payload[None, :], xp.zeros((), xp.uint16)).astype(xp.uint16),
            axis=1,
        ).astype(xp.uint16)
        out = out | add
    return out


# ---------------------------------------------------------------------------
# Pair-coalesced quotient map ("QMapP") — ONE [1,2]-u64 row gather per TWO
# reference positions.
#
# The QMap spends 2 u64 gathers per position; coalescing two positions into
# one 16-byte row lookup puts the same plane pass at ~1 row gather per
# position (the gather rates of both layouts on the H100 are not measured;
# scripts/bench_scan_parts.py times them).
#
# Key idea: consecutive (k-1)-mers q_i = ref[i:i+k-1] and q_{i+1} share the
# (k-2)-mer r = q_i[1:] = q_{i+1}[:-1]. Index the table by *canonical
# (k-2)-mers*; the 128-bit slot stores the 9-bit fused payloads (ext/pre
# bitmaps + repeat bit, same semantics as QMap) of ALL EIGHT (k-1)-mers
# containing r̂:
#
#     L[y] = payload of (y + r̂), oriented as-read, y = 0..3   (36 bits)
#     R[x] = payload of (r̂ + x), oriented as-read, x = 0..3   (36 bits)
#
# One lookup at canon(r_i) (i even) + the two flanking bases yields the
# payloads of q_i and q_{i+1} exactly:
#
#     strand (r == r̂):   pay(q_i) = L[codes[i]]        pay(q_{i+1}) = R[x]
#     rc     (r == rc̄):   pay(q_i) = FLIP(R[y^2])       pay(q_{i+1}) = FLIP(L[x^2])
#
# where x = codes[i+k-1], FLIP is the 9-bit rc payload transform
# (ext'=shuffle02(pre), pre'=shuffle02(ext), rep unchanged), and a missing
# bucket is correct-by-construction: q_i having any payload implies r is a
# suffix of a table (k-1)-mer, hence bucket(r) exists.
#
# Slot encoding (2 u64 lanes, 2-choice quotient cuckoo, log_size >= 19):
#   lane0: [0:8) L bits 28..35 | [8] hash-choice | [9] valid | [10:55) rem45
#   lane1: [0:36) R | [36:64) L bits 0..27
"""Reference semantics covered: identical to QMap (src/FindBreakpoints.hpp:
560-622 membership/degrees + :1012-1046 repeat queries), at half the probes."""

_QP_REM_BITS = 45
_QP_REM_MASK = np.uint64((1 << _QP_REM_BITS) - 1)
_QP_CHOICE = np.uint64(1 << 8)
_QP_VALID = np.uint64(1 << 9)
_QP_L36 = np.uint64((1 << 36) - 1)


@dataclass
class QMapP:
    slots: np.ndarray  # u64 [2**log_size, 2]; all-zero row = empty
    log_size: int
    k: int
    stash_keys: np.ndarray  # u64 [>=1] sorted (EMPTY-padded)
    stash_l: np.ndarray  # u64 L36 per stash key
    stash_r: np.ndarray  # u64 R36 per stash key

    @property
    def nbytes(self):
        return self.slots.nbytes


def _flip9(p, xp=np):
    """rc transform of a 9-bit fused payload (as-read -> other strand)."""
    ext = p & 0xF
    pre = (p >> 4) & 0xF
    return (
        _shuffle02(pre, xp)
        | (_shuffle02(ext, xp) << 4)
        | (p & 0x100)
    )


def build_fused_pair(
    solid_canonical: np.ndarray,
    k: int,
    repeat_canonical: np.ndarray,
    load_factor: float = 0.35,
) -> "QMapP":
    """Build the pair-coalesced map from the same inputs as build_fused."""
    assert 3 <= k <= 32
    qp = _build_fused_pair_native(solid_canonical, k, repeat_canonical, load_factor)
    if qp is not None:
        return qp
    keys1, vals1 = _fused_entries(solid_canonical, k, repeat_canonical)
    km1, km2 = k - 1, k - 2
    mask2 = K.kmer_mask(km2)

    # bucket keys: canonical (k-2)-mers occurring as prefix or suffix of any
    # (k-1)-mer key (either orientation)
    both = np.concatenate([keys1, K.revcomp_u64(keys1, km1)])
    r = np.unique(
        K.canonical_u64(
            np.concatenate([(both >> np.uint64(2)) & mask2, both & mask2]), km2
        )
    )

    def fetch(s_asread):
        """9-bit payload of (k-1)-mer string s, oriented as-read."""
        c = K.canonical_u64(s_asread, km1)
        if keys1.size == 0:
            return np.zeros(s_asread.shape, np.uint64)
        idx = np.minimum(np.searchsorted(keys1, c), keys1.size - 1)
        p = np.where(keys1[idx] == c, vals1[idx], 0).astype(np.uint16)
        ext, pre = _oriented((p & 0xFF).astype(np.uint8), s_asread == c, np)
        rep = (p >> 8) & 1
        return (
            ext.astype(np.uint64)
            | (pre.astype(np.uint64) << np.uint64(4))
            | (rep.astype(np.uint64) << np.uint64(8))
        )

    shift_first = np.uint64(2 * km2)
    L = np.zeros(r.shape, np.uint64)
    R = np.zeros(r.shape, np.uint64)
    for b in range(4):
        L |= fetch((np.uint64(b) << shift_first) | r) << np.uint64(9 * b)
        R |= fetch((r << np.uint64(2)) | np.uint64(b)) << np.uint64(9 * b)

    # place keys (payload-free native cuckoo), then recover row indices by
    # binary search over the sorted unique key set
    em = _place(r, np.zeros(r.size, np.uint8), load_factor, min_log=19)
    if em.log_size < 19:
        em = _place(r, np.zeros(r.size, np.uint8), load_factor, min_log=19)
    S = 1 << em.log_size
    slots = np.zeros((S, 2), np.uint64)
    occ = em.keys != EMPTY
    okeys = em.keys[occ]
    ridx = np.searchsorted(r, okeys)
    Lv, Rv = L[ridx], R[ridx]

    # recover hash choice + rem per occupied slot (as _quotient_encode)
    shift = np.uint64(64 - em.log_size)
    sidx = np.nonzero(occ)[0].astype(np.uint64)
    h1 = _mix(okeys, _H1)
    h2 = _mix(okeys, _H2)
    use1 = (h1 >> shift) == sidx
    if not (use1 | ((h2 >> shift) == sidx)).all():
        raise AssertionError("pair map: slot not reachable by either hash")
    h = np.where(use1, h1, h2)
    rem = h & ((np.uint64(1) << shift) - np.uint64(1))
    lane0 = (
        (Lv >> np.uint64(28))
        | np.where(use1, np.uint64(0), _QP_CHOICE)
        | _QP_VALID
        | (rem << np.uint64(10))
    )
    lane1 = Rv | ((Lv & np.uint64((1 << 28) - 1)) << np.uint64(36))
    slots[occ, 0] = lane0
    slots[occ, 1] = lane1

    sk = em.stash_keys
    if sk.size:
        sidx2 = np.searchsorted(r, sk)
        sl, sr = L[sidx2], R[sidx2]
        order = np.argsort(sk)
        sk, sl, sr = sk[order], sl[order], sr[order]
    else:
        sk = np.array([EMPTY], np.uint64)
        sl = np.zeros(1, np.uint64)
        sr = np.zeros(1, np.uint64)
    return QMapP(slots, em.log_size, k, sk, sl, sr)


def _build_fused_pair_native(solid, k, repeat, load_factor):
    """One-pass native build (native/tables.cpp qpmap_build). Returns None
    when the native library is unavailable (numpy fallback takes over)."""
    import ctypes

    lib = _load_native()
    if lib is None or not hasattr(lib, "qpmap_build"):
        return None
    solid = np.ascontiguousarray(solid, dtype=np.uint64)
    repeat = np.ascontiguousarray(np.unique(np.asarray(repeat, dtype=np.uint64)))
    n_est = max(int(solid.size) + int(repeat.size), 4)
    log1 = max(12, int(np.ceil(np.log2(n_est / load_factor))))
    log2s = max(19, int(np.ceil(np.log2(n_est / load_factor))))
    for _ in range(5):
        t1_keys = np.full(1 << log1, EMPTY, np.uint64)
        t1_vals = np.zeros(1 << log1, np.uint16)
        t1_choice = np.zeros(1 << log1, np.uint8)
        t2_keys = np.full(1 << log2s, EMPTY, np.uint64)
        t2_choice = np.zeros(1 << log2s, np.uint8)
        slots2 = np.zeros((1 << log2s, 2), np.uint64)
        stash_k = np.zeros(64, np.uint64)
        stash_l = np.zeros(64, np.uint64)
        stash_r = np.zeros(64, np.uint64)
        rc = lib.qpmap_build(
            solid.ctypes.data_as(ctypes.c_void_p), solid.size, k,
            repeat.ctypes.data_as(ctypes.c_void_p), repeat.size, log1, log2s,
            t1_keys.ctypes.data_as(ctypes.c_void_p),
            t1_vals.ctypes.data_as(ctypes.c_void_p),
            t1_choice.ctypes.data_as(ctypes.c_void_p),
            t2_keys.ctypes.data_as(ctypes.c_void_p),
            t2_choice.ctypes.data_as(ctypes.c_void_p),
            slots2.ctypes.data_as(ctypes.c_void_p),
            stash_k.ctypes.data_as(ctypes.c_void_p),
            stash_l.ctypes.data_as(ctypes.c_void_p),
            stash_r.ctypes.data_as(ctypes.c_void_p), 64,
        )
        if rc >= 0:
            n_stash = int(rc)
            order = np.argsort(stash_k[:n_stash])
            sk = stash_k[:n_stash][order]
            sl = stash_l[:n_stash][order]
            sr = stash_r[:n_stash][order]
            if sk.size == 0:
                sk = np.array([EMPTY], np.uint64)
                sl = np.zeros(1, np.uint64)
                sr = np.zeros(1, np.uint64)
            return QMapP(slots2, log2s, k, sk, sl, sr)
        if rc == -1:
            log1 += 1
        else:
            log2s += 1
    return None


def lookup_qp(qp: QMapP, canon_keys, xp=np):
    """Pair lookup: 2 [1,2]-row gathers (+ tiny stash pass). Returns
    (L36, R36) u64 arrays (0 for absent buckets)."""
    keys = xp.asarray(canon_keys, dtype=xp.uint64)
    shift = np.uint64(64 - qp.log_size)
    rem_mask = (np.uint64(1) << shift) - np.uint64(1)
    l36 = xp.zeros(keys.shape, xp.uint64)
    r36 = xp.zeros(keys.shape, xp.uint64)
    for i, const in enumerate((_H1, _H2)):
        h = (keys ^ (keys >> np.uint64(33))) * const
        h = h ^ (h >> np.uint64(29))
        slot = (h >> shift).astype(xp.int32)
        rows = qp.slots[slot]  # [N, 2] row gather
        lane0 = rows[..., 0]
        lane1 = rows[..., 1]
        hit = (
            (((lane0 >> np.uint64(10)) & _QP_REM_MASK) == (h & rem_mask))
            & ((lane0 & _QP_VALID) != 0)
            & (((lane0 & _QP_CHOICE) != 0) == (i == 1))
        )
        lv = ((lane0 & np.uint64(0xFF)) << np.uint64(28)) | (lane1 >> np.uint64(36))
        rv = lane1 & _QP_L36
        l36 = xp.where(hit, lv, l36)
        r36 = xp.where(hit, rv, r36)
    if int(qp.stash_keys.shape[0]):
        eq = keys[:, None] == qp.stash_keys[None, :]
        l36 = l36 | xp.sum(
            xp.where(eq, qp.stash_l[None, :], xp.zeros((), xp.uint64)), axis=-1
        )
        r36 = r36 | xp.sum(
            xp.where(eq, qp.stash_r[None, :], xp.zeros((), xp.uint64)), axis=-1
        )
    return l36, r36


def pair_payload_stream(qp: QMapP, codes, n_pay: int, xp=np):
    """The per-position fused payload stream pay[j] (9-bit, oriented as-read)
    for the (k-1)-mers q_0..q_{n_pay-1} of `codes`, via one pair lookup per
    two positions. Host (numpy) reference implementation; the device version
    lives in find/scan_device.py scan_planes_device_qp."""
    k = qp.k
    km2 = k - 2
    w = codes.shape[0]
    n_pairs = (n_pay + 1) // 2
    c = np.where(codes == 255, 0, codes).astype(np.uint64)
    from . import kmers as _K

    # r_m = (k-2)-mer at position 2m+1 (the shared core of q_{2m}, q_{2m+1})
    full, _valid = _K.kmers_from_codes(np.where(codes == 255, 0, codes).astype(np.uint8), km2)
    ridx = 1 + 2 * np.arange(n_pairs)
    ridx = np.minimum(ridx, full.shape[0] - 1)
    r_asread = full[ridx]
    canon_r = _K.canonical_u64(r_asread, km2)
    strand = r_asread == canon_r
    L36, R36 = lookup_qp(qp, canon_r, xp=np)
    y = c[np.minimum(2 * np.arange(n_pairs), w - 1)]
    x = c[np.minimum(2 * np.arange(n_pairs) + k - 1, w - 1)]
    sub = lambda blk, i4: (blk >> (np.uint64(9) * i4)) & np.uint64(0x1FF)
    pay_even = np.where(strand, sub(L36, y), _flip9(sub(R36, y ^ np.uint64(2)), np))
    pay_odd = np.where(strand, sub(R36, x), _flip9(sub(L36, x ^ np.uint64(2)), np))
    pay = np.empty(2 * n_pairs, np.uint64)
    pay[0::2] = pay_even
    pay[1::2] = pay_odd
    return pay[:n_pay].astype(np.uint16)
