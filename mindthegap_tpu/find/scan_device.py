"""Device (XLA) implementation of the find-scan plane pass.

This is the device compute path for the `find` hot loop (reference
src/FindBreakpoints.hpp:560-622: |ref| iterations x ~11 graph probes per
position). The whole window is processed as one fused jit program:

  codes[W] (uint8)  ->  fwd kmers, validity, canonical membership,
                        fwd-strand in/out degrees, (k-1) repeat bits

Engine lineage (all exact, selected by -scan-engine): sorted-array binary
search (scan_planes_device, the simple reference point), the fused quotient
map (~2 u64 gathers/position, scan_planes_device_q), the single-probe
bucket map (scan_planes_device_qb), and the pair-coalesced map (one
[1,2]-u64 row lookup per TWO positions, scan_planes_device_qp — the
`auto` choice). Windows are padded to fixed
shapes so each (W, k, table) signature compiles once; the multi-chip path
shards the window axis over the mesh (mindthegap_tpu/parallel/mesh.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import kmers as K

INVALID = 255


def pack_codes_host(rows: np.ndarray):
    """2-bit-pack base codes for the host->device boundary (4x less upload
    than raw u8 codes). rows: u8[..., n] with n % 8 == 0
    (255 = invalid). Returns (packed u8[..., n/4] — base j in bits 2*(j%4)
    of byte j//4 — and bad u8[..., n/8], np.packbits bit order)."""
    n = rows.shape[-1]
    assert n % 8 == 0
    bad = rows == INVALID
    c = np.where(bad, 0, rows).astype(np.uint8)
    q = c.reshape(rows.shape[:-1] + (n // 4, 4))
    packed = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)
    badbits = np.packbits(bad, axis=-1)
    return packed, badbits


def unpack_codes_device(packed, badbits):
    """Device inverse of pack_codes_host (elementwise + reshape only — no
    gathers): returns u8[..., 4*m] codes with 255 at bad positions."""
    cols = jnp.stack(
        [((packed >> jnp.uint8(2 * j)) & jnp.uint8(3)) for j in range(4)], axis=-1
    ).reshape(packed.shape[:-1] + (-1,))
    bits = jnp.stack(
        [((badbits >> jnp.uint8(7 - i)) & jnp.uint8(1)) for i in range(8)], axis=-1
    ).reshape(badbits.shape[:-1] + (-1,))
    return jnp.where(bits != 0, jnp.uint8(INVALID), cols)


def rolling_kmers_device(codes, k: int):
    """Forward kmers + validity for a padded window (jnp, jittable).

    codes: uint8[W] (255 = invalid/padding). Returns (fwd u64[P], valid
    bool[P]) with P = W - k + 1."""
    w = codes.shape[0]
    p = w - k + 1
    bad = codes == INVALID
    c = jnp.where(bad, 0, codes).astype(jnp.uint64)
    fwd = jnp.zeros((p,), jnp.uint64)
    for j in range(k):  # k is static; unrolled into shifts/ors and fused
        fwd = (fwd << jnp.uint64(2)) | jax.lax.dynamic_slice(c, (j,), (p,))
    badc = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(bad.astype(jnp.int32))])
    valid = (badc[k:] - badc[:-k]) == 0
    return fwd, valid


def _member(sorted_arr, keys):
    if sorted_arr.shape[0] == 0:
        return jnp.zeros(keys.shape, bool)
    idx = jnp.searchsorted(sorted_arr, keys)
    idx = jnp.minimum(idx, sorted_arr.shape[0] - 1)
    return sorted_arr[idx] == keys


@partial(jax.jit, static_argnames=("k",))
def scan_planes_device(codes, solid_sorted, repeat_sorted, k: int):
    """The full plane pass for one (padded) window. Returns a dict of
    per-position planes, all shape [W-k+1]."""
    fwd, valid = rolling_kmers_device(codes, k)
    canon = K.canonical_u64(fwd, k, jnp)
    contains = _member(solid_sorted, canon)

    mask = K.kmer_mask(k)
    shift_hi = jnp.uint64(2 * (k - 1))
    nb_out = jnp.zeros(fwd.shape, jnp.int32)
    nb_in = jnp.zeros(fwd.shape, jnp.int32)
    for x in range(4):
        out_n = ((fwd << jnp.uint64(2)) | jnp.uint64(x)) & mask
        nb_out = nb_out + _member(solid_sorted, K.canonical_u64(out_n, k, jnp))
        in_n = (fwd >> jnp.uint64(2)) | (jnp.uint64(x) << shift_hi)
        nb_in = nb_in + _member(solid_sorted, K.canonical_u64(in_n, k, jnp))
    nb_out = jnp.where(contains, nb_out, 0)
    nb_in = jnp.where(contains, nb_in, 0)

    km1_mask = K.kmer_mask(k - 1)
    suffix = fwd & km1_mask
    prefix = (fwd >> jnp.uint64(2)) & km1_mask
    suffix_rep = _member(repeat_sorted, K.canonical_u64(suffix, k - 1, jnp))
    prefix_rep = _member(repeat_sorted, K.canonical_u64(prefix, k - 1, jnp))

    return {
        "fwd": fwd,
        "valid": valid,
        "contains": contains,
        "nb_in": nb_in,
        "nb_out": nb_out,
        "suffix_rep": suffix_rep,
        "prefix_rep": prefix_rep,
    }


@partial(jax.jit, static_argnames=("log_size", "k"))
def scan_planes_device_q(codes, slots, stash_k, stash_v, log_size: int, k: int):
    """Plane pass over the fused quotient map (ops/extmap.py QMap): ~2 HBM
    gathers per position for the full plane set — membership, fwd-strand
    degrees AND both (k-1)-mer repeat bits ride in one 9-bit payload.
    Superseded as flagship by the pair-coalesced map (_qp) below."""
    from ..ops import extmap as X

    qm = X.QMap(slots, log_size, stash_k, stash_v)

    q, _qvalid = rolling_kmers_device(codes, k - 1)
    fwd, valid = rolling_kmers_device(codes, k)
    p = fwd.shape[0]

    canon_q = K.canonical_u64(q, k - 1, jnp)
    is_canon = q == canon_q
    pay16 = X.lookup_q(qm, canon_q, xp=jnp)
    payload = (pay16 & jnp.uint16(0xFF)).astype(jnp.uint8)
    rep = ((pay16 >> jnp.uint16(8)) & jnp.uint16(1)).astype(bool)

    last_base = jnp.where(codes[k - 1 :] == INVALID, 0, codes[k - 1 :]).astype(jnp.uint8)
    contains, nb_in, nb_out = X.planes_from_payload(
        payload[:p], payload[1:], is_canon[:p], is_canon[1:], last_base, xp=jnp
    )
    nb_out = jnp.where(contains, nb_out, 0).astype(jnp.int32)
    nb_in = jnp.where(contains, nb_in, 0).astype(jnp.int32)

    return {
        "fwd": fwd,
        "valid": valid,
        "contains": contains,
        "nb_in": nb_in,
        "nb_out": nb_out,
        "suffix_rep": rep[1:],
        "prefix_rep": rep[:p],
    }


@partial(jax.jit, static_argnames=("log_nb", "k"))
def scan_planes_device_qb(codes, slots, stash_k, stash_v, log_nb: int, k: int):
    """Plane pass over the single-probe bucket map (ops/extmap.py QMapB):
    ONE 128-byte bucket gather per position for the full plane set — half
    the gather issues of the 2-probe cuckoo QMap (the pass is bound by the
    per-index gather issue rate, not bytes; see QMapB header math)."""
    from ..ops import extmap as X

    qm = X.QMapB(slots, log_nb, stash_k, stash_v)

    q, _qvalid = rolling_kmers_device(codes, k - 1)
    fwd, valid = rolling_kmers_device(codes, k)
    p = fwd.shape[0]

    canon_q = K.canonical_u64(q, k - 1, jnp)
    is_canon = q == canon_q
    pay16 = X.lookup_qb_chunked(qm, canon_q)
    payload = (pay16 & jnp.uint16(0xFF)).astype(jnp.uint8)
    rep = ((pay16 >> jnp.uint16(8)) & jnp.uint16(1)).astype(bool)

    last_base = jnp.where(codes[k - 1 :] == INVALID, 0, codes[k - 1 :]).astype(jnp.uint8)
    contains, nb_in, nb_out = X.planes_from_payload(
        payload[:p], payload[1:], is_canon[:p], is_canon[1:], last_base, xp=jnp
    )
    nb_out = jnp.where(contains, nb_out, 0).astype(jnp.int32)
    nb_in = jnp.where(contains, nb_in, 0).astype(jnp.int32)

    return {
        "fwd": fwd,
        "valid": valid,
        "contains": contains,
        "nb_in": nb_in,
        "nb_out": nb_out,
        "suffix_rep": rep[1:],
        "prefix_rep": rep[:p],
    }


@partial(jax.jit, static_argnames=("salt", "log_size", "k"))
def scan_planes_device_q_span(codes, slots, sat, stash_k64, stash_sat, stash_v,
                              salt: int, log_size: int, k: int):
    """Plane pass for 32 < k <= 256 over the multi-word fused quotient map
    (ops/extmap.py QMapSpan): per position ~2*Wq gathers (Wq = words per
    (k-1)-mer). Returns the same plane dict with `fwd_words` as a stacked
    (Wk, P) u64 array (converted to python-int fwd by the host wrapper)."""
    from ..ops import extmap as X
    from ..ops import span_device as SD

    qm = X.QMapSpan(slots, sat, log_size, salt, stash_k64, stash_sat, stash_v)

    qwords, _qvalid = SD.rolling_span_device(codes, k - 1)
    fwd_words, valid = SD.rolling_span_device(codes, k)
    p = fwd_words.shape[1]

    canon_q, is_canon = SD.canonical_span_device(qwords, k - 1)
    pay16 = X.lookup_q_span(qm, canon_q, xp=jnp)
    payload = (pay16 & jnp.uint16(0xFF)).astype(jnp.uint8)
    rep = ((pay16 >> jnp.uint16(8)) & jnp.uint16(1)).astype(bool)

    last_base = jnp.where(codes[k - 1 :] == INVALID, 0, codes[k - 1 :]).astype(jnp.uint8)
    contains, nb_in, nb_out = X.planes_from_payload(
        payload[:p], payload[1:], is_canon[:p], is_canon[1:], last_base, xp=jnp
    )
    nb_out = jnp.where(contains, nb_out, 0).astype(jnp.int32)
    nb_in = jnp.where(contains, nb_in, 0).astype(jnp.int32)

    return {
        "fwd_words": fwd_words,
        "valid": valid,
        "contains": contains,
        "nb_in": nb_in,
        "nb_out": nb_out,
        "suffix_rep": rep[1:],
        "prefix_rep": rep[:p],
    }


@partial(jax.jit, static_argnames=("salt", "log_size", "k"))
def scan_pay_device_q_span(codes, slots, sat, stash_k64, stash_sat, stash_v,
                           salt: int, log_size: int, k: int):
    """Packed variant of scan_planes_device_q_span (32 < k <= 256): ships
    the 8-bit fused payload plus bit-packed repeat and strand planes
    (~1.25 B/position) instead of fwd_words + plane tuple (8*ceil(k/32)+10
    B/position) — the span q-layout payload is NOT pre-oriented, so the
    host needs the canonical-strand bit to orient it (planes_from_pay_span)."""
    from ..ops import extmap as X
    from ..ops import span_device as SD

    qm = X.QMapSpan(slots, sat, log_size, salt, stash_k64, stash_sat, stash_v)

    qwords, _qvalid = SD.rolling_span_device(codes, k - 1)
    canon_q, is_canon = SD.canonical_span_device(qwords, k - 1)
    pay16 = X.lookup_q_span(qm, canon_q, xp=jnp)
    n_pay = pay16.shape[0]
    n8 = -(-n_pay // 8) * 8
    pad = n8 - n_pay
    pay16 = jnp.concatenate([pay16, jnp.zeros(pad, pay16.dtype)])
    strand = jnp.concatenate([is_canon, jnp.zeros(pad, bool)])
    pay8 = (pay16 & jnp.uint16(0xFF)).astype(jnp.uint8)
    w = jnp.array([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    rep_bits = ((pay16 >> jnp.uint16(8)) & jnp.uint16(1)).astype(jnp.uint8).reshape(-1, 8)
    str_bits = strand.astype(jnp.uint8).reshape(-1, 8)
    rep8 = (rep_bits * w[None, :]).sum(axis=1).astype(jnp.uint8)
    str8 = (str_bits * w[None, :]).sum(axis=1).astype(jnp.uint8)
    return {"pay8": pay8[:n_pay], "rep8": rep8, "str8": str8}


def planes_from_pay_span(pay8, rep8, str8, codes: np.ndarray, k: int):
    """Host side of the packed span path: rebuild the full Planes from the
    payload byte stream + packed repeat/strand bits + local fwd/valid span
    extraction. Bit-identical to scan_planes_device_q_span's outputs."""
    from ..ops import extmap as X
    from ..ops.span import Span
    from .scan import Planes

    sp = Span(k)
    fwd_rows, valid = sp.from_codes(codes)
    p = fwd_rows.shape[0]
    pay8 = np.asarray(pay8, np.uint8)
    rep = np.unpackbits(np.asarray(rep8, np.uint8)).astype(bool)
    is_canon = np.unpackbits(np.asarray(str8, np.uint8)).astype(bool)
    last_base = np.where(codes[k - 1 :] == INVALID, 0, codes[k - 1 :]).astype(np.uint8)
    contains, nb_in, nb_out = X.planes_from_payload(
        pay8[:p], pay8[1 : p + 1], is_canon[:p], is_canon[1 : p + 1], last_base, xp=np
    )
    nb_out = np.where(contains, nb_out, 0).astype(np.int32)
    nb_in = np.where(contains, nb_in, 0).astype(np.int32)
    return Planes(
        valid=valid,
        fwd=sp.to_ints(fwd_rows),
        contains=contains,
        nb_in=nb_in,
        nb_out=nb_out,
        suffix_rep=rep[1 : p + 1],
        prefix_rep=rep[:p],
        fwd_rows=fwd_rows,
    )


def compute_planes_device(codes: np.ndarray, k: int, solid_sorted, repeat_sorted, window: int = 1 << 20):
    """Host wrapper: pads/windows a chromosome, runs the device pass, stitches
    numpy planes identical to find.scan.compute_planes."""
    from .scan import Planes

    n = codes.shape[0]
    if n < k:
        z = np.zeros(0)
        return Planes(*(z.astype(t) for t in (bool, np.uint64, bool, np.int32, np.int32, bool, bool)))

    solid_sorted = jnp.asarray(solid_sorted)
    repeat_sorted = jnp.asarray(repeat_sorted)

    halo = k - 1
    outs = {key: [] for key in ("fwd", "valid", "contains", "nb_in", "nb_out", "suffix_rep", "prefix_rep")}
    pos = 0
    npos = n - k + 1
    while pos < npos:
        take = min(window - halo, npos - pos)
        chunk = np.full(window, INVALID, np.uint8)
        chunk[: take + halo] = codes[pos : pos + take + halo]
        res = scan_planes_device(jnp.asarray(chunk), solid_sorted, repeat_sorted, k)
        for key in outs:
            outs[key].append(np.asarray(res[key])[:take])
        pos += take
    return Planes(
        valid=np.concatenate(outs["valid"]),
        fwd=np.concatenate(outs["fwd"]),
        contains=np.concatenate(outs["contains"]),
        nb_in=np.concatenate(outs["nb_in"]),
        nb_out=np.concatenate(outs["nb_out"]),
        suffix_rep=np.concatenate(outs["suffix_rep"]),
        prefix_rep=np.concatenate(outs["prefix_rep"]),
    )


def _pair_pay_device(codes, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """Shared core of the qp kernels: the per-position fused 9-bit payload
    stream (u64[2*n_pairs], oriented as-read) via one pair-map lookup per
    TWO positions. One lookup at the shared (k-2)-mer of q_i, q_{i+1}
    yields both payloads (QMapP header math)."""
    from ..ops import extmap as X

    qp = X.QMapP(slots2, log_size, k, stash_k, stash_l, stash_r)
    p = codes.shape[0] - k + 1
    n_pay = p + 1
    n_pairs = (n_pay + 1) // 2

    # Even/odd base columns: the ONLY strided reads, and on the 1-byte
    # array (slicing the u8 codes first moves 8x less data than a
    # stride-2 relayout of u64 streams). Everything downstream is
    # contiguous dynamic slices.
    clean = jnp.where(codes == INVALID, 0, codes).astype(jnp.uint8)
    n2 = n_pairs + (k + 1) // 2 + 1
    clean_p = jnp.concatenate(
        [clean, jnp.zeros(2 * n2 - clean.shape[0], jnp.uint8)]
    )
    col0 = clean_p[0::2].astype(jnp.uint64)  # bases at even positions
    col1 = clean_p[1::2].astype(jnp.uint64)  # bases at odd positions

    # r_m = (k-2)-mer at position 2m+1, assembled from contiguous column
    # slices (base 2m+1+j lives in col_{(1+j)%2}[m + (1+j)//2])
    r_asread = jnp.zeros((n_pairs,), jnp.uint64)
    for j in range(k - 2):
        par = (1 + j) & 1
        off = (1 + j) >> 1
        col = col1 if par else col0
        r_asread = (r_asread << jnp.uint64(2)) | jax.lax.dynamic_slice(col, (off,), (n_pairs,))
    canon_r = K.canonical_u64(r_asread, k - 2, jnp)
    strand = r_asread == canon_r
    l36, r36 = X.lookup_qp(qp, canon_r, xp=jnp)

    y = jax.lax.dynamic_slice(col0, (0,), (n_pairs,))
    # base 2m + (k-1): even when k is odd -> col0, else col1
    if (k - 1) % 2 == 0:
        x = jax.lax.dynamic_slice(col0, ((k - 1) // 2,), (n_pairs,))
    else:
        x = jax.lax.dynamic_slice(col1, ((k - 2) // 2,), (n_pairs,))
    sub = lambda blk, i4: (blk >> (jnp.uint64(9) * i4)) & jnp.uint64(0x1FF)
    pay_even = jnp.where(strand, sub(l36, y), X._flip9(sub(r36, y ^ jnp.uint64(2)), jnp))
    pay_odd = jnp.where(strand, sub(r36, x), X._flip9(sub(l36, x ^ jnp.uint64(2)), jnp))
    return jnp.stack([pay_even, pay_odd], axis=1).reshape(-1)


@partial(jax.jit, static_argnames=("log_size", "k"))
def scan_planes_device_qp(codes, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """Plane pass over the pair-coalesced quotient map (ops/extmap.py QMapP):
    ONE row lookup per TWO positions (_pair_pay_device), planes derived
    on device. The packed sibling (scan_pay_device_qp) ships the payload
    stream instead and derives planes on host."""
    from ..ops import extmap as X

    fwd, valid = rolling_kmers_device(codes, k)
    p = fwd.shape[0]
    n_pay = p + 1
    pay = _pair_pay_device(codes, slots2, stash_k, stash_l, stash_r, log_size, k)
    pay = pay[:n_pay].astype(jnp.uint16)

    # payloads are pre-oriented: planes drop the strand select
    ext_i = (pay[:p] & jnp.uint16(0xF)).astype(jnp.uint8)
    pre_i = ((pay[:p] >> jnp.uint16(4)) & jnp.uint16(0xF)).astype(jnp.uint8)
    ext_i1 = (pay[1:] & jnp.uint16(0xF)).astype(jnp.uint8)

    last_base = jnp.where(codes[k - 1 :] == INVALID, 0, codes[k - 1 :]).astype(jnp.uint8)
    contains = ((ext_i >> last_base) & 1).astype(bool)
    nb_out = jnp.where(contains, X._popcount4(ext_i1, jnp), 0).astype(jnp.int32)
    nb_in = jnp.where(contains, X._popcount4(pre_i, jnp), 0).astype(jnp.int32)

    return {
        "fwd": fwd,
        "valid": valid,
        "contains": contains,
        "nb_in": nb_in,
        "nb_out": nb_out,
        "suffix_rep": ((pay[1:] >> jnp.uint16(8)) & 1).astype(bool),
        "prefix_rep": ((pay[:p] >> jnp.uint16(8)) & 1).astype(bool),
    }


@partial(jax.jit, static_argnames=("log_size", "k"))
def scan_pay_device_qp(codes, slots2, stash_k, stash_l, stash_r, log_size: int, k: int):
    """Packed variant of scan_planes_device_qp: returns ONLY the 9-bit fused
    payload stream pay[j] (u16[P+1], oriented as-read) — 2 bytes/position
    across the device->host boundary instead of the ~20-byte plane tuple.
    The host derives contains/nb_in/nb_out/repeat bits from consecutive
    payloads (planes_from_pay) and rolls fwd/valid itself (native C++
    extract) — the same math the full kernel fuses, moved to where it is
    free. The CLI device engine rides this when planes leave the chip."""
    p = codes.shape[0] - k + 1
    n_pay = p + 1
    n_pairs = (n_pay + 1) // 2
    pay = _pair_pay_device(codes, slots2, stash_k, stash_l, stash_r, log_size, k)
    # pad to a multiple of 8 so the repeat bits pack densely
    n8 = -(-n_pay // 8) * 8
    pay = jnp.concatenate([pay, jnp.zeros(n8 - 2 * n_pairs if n8 > 2 * n_pairs else 0, jnp.uint64)])[:n8]
    pay8 = pay.astype(jnp.uint8)  # ext|pre nibbles
    rep = ((pay >> jnp.uint64(8)) & jnp.uint64(1)).astype(jnp.uint8).reshape(-1, 8)
    # big-endian bit order, matching np.unpackbits on host
    w = jnp.array([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    rep8 = (rep * w[None, :]).sum(axis=1).astype(jnp.uint8)
    return {"pay8": pay8[:n_pay], "rep8": rep8}


@partial(jax.jit, static_argnames=("log_size", "k", "exc_cap"))
def scan_cls_device_qp(packed, badbits, slots2, stash_k, stash_l, stash_r,
                       log_size: int, k: int, exc_cap: int):
    """Reference-delta variant of scan_pay_device_qp: instead of shipping
    every 9-bit payload, classify each payload index j against what the
    reference's OWN continuation implies —

      cls 0 (REF):  pay == 1-hot ext at base(j+k-1) | 1-hot pre at
                    base(j-1), rep=0 — the unique-coverage common case;
                    the host automaton reconstructs it from the sequence
      cls 1 (ZERO): pay == 0 (gap interior)
      cls 3 (REP):  REF payload with the repeat bit set (repeat-dense
                    reference regions stay class-coded)
      cls 2 (EXC):  anything else — branching, window-edge and N-adjacent
                    payloads — shipped explicitly, compacted in payload
                    order

    Output: 2-bit class stream (0.25 B/position) + exc16 u16[exc_cap] +
    n_exc. Device->host drops ~4x vs the packed payload stream (and ~16x vs
    the plane tuple).
    Input is 2-bit packed codes + bad mask (pack_codes_host). n_exc >
    exc_cap means the window must be re-dispatched through the dense
    kernel (host fallback)."""
    codes = unpack_codes_device(packed, badbits)
    w = codes.shape[0]
    p = w - k + 1
    n_pay = p + 1
    pay = _pair_pay_device(codes, slots2, stash_k, stash_l, stash_r, log_size, k)
    n4 = -(-n_pay // 4) * 4
    pay = jnp.concatenate([pay, jnp.zeros(max(0, n4 - pay.shape[0]), jnp.uint64)])[:n4]

    b_hi = jnp.concatenate([codes[k - 1 :], jnp.full(n4 - p, INVALID, jnp.uint8)])
    b_lo = jnp.concatenate([jnp.full(1, INVALID, jnp.uint8), codes])[:n4]
    ok = (b_hi < 4) & (b_lo < 4)
    ref_pay = (jnp.uint64(1) << b_hi.astype(jnp.uint64)) | (
        (jnp.uint64(1) << b_lo.astype(jnp.uint64)) << jnp.uint64(4)
    )
    ref_hit = ok & ((pay & jnp.uint64(0xFF)) == ref_pay)
    rep_bit = (pay >> jnp.uint64(8)) & jnp.uint64(1)
    cls = jnp.where(ref_hit, jnp.where(rep_bit != 0, jnp.uint8(3), jnp.uint8(0)),
                    jnp.where(pay == 0, jnp.uint8(1), jnp.uint8(2)))
    q = cls.reshape(-1, 4)
    cls2 = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)).astype(jnp.uint8)

    not_exc = (cls != 2).astype(jnp.uint8)
    idx = jnp.arange(n4, dtype=jnp.int32)
    _, _, exc = jax.lax.sort((not_exc, idx, pay.astype(jnp.uint16)), num_keys=2)
    n_exc = jnp.sum((cls == 2).astype(jnp.int32))
    return {"cls2": cls2, "exc16": exc[:exc_cap], "n_exc": n_exc}


def planes_from_pay(pay8: np.ndarray, rep8: np.ndarray, codes: np.ndarray, k: int):
    """Host side of the packed qp path: derive the full Planes from the
    payload byte stream + packed repeat bits (numpy; ~10 vector ops) +
    native fwd/valid extraction. Bit-identical to scan_planes_device_qp's
    plane outputs."""
    from ..ops import extmap as X
    from .scan import Planes

    fwd, valid = K.kmers_from_codes(codes, k)
    p = fwd.shape[0]
    pay8 = np.asarray(pay8, np.uint8)
    rep = np.unpackbits(np.asarray(rep8, np.uint8))
    ext_i = pay8[:p] & np.uint8(0xF)
    pre_i = (pay8[:p] >> np.uint8(4)) & np.uint8(0xF)
    ext_i1 = pay8[1 : p + 1] & np.uint8(0xF)
    last_base = np.where(codes[k - 1 :] == INVALID, 0, codes[k - 1 :]).astype(np.uint8)
    contains = ((ext_i >> last_base) & 1).astype(bool)
    nb_out = np.where(contains, X._popcount4(ext_i1, np), 0).astype(np.int32)
    nb_in = np.where(contains, X._popcount4(pre_i, np), 0).astype(np.int32)
    return Planes(
        valid=valid,
        fwd=fwd,
        contains=contains,
        nb_in=nb_in,
        nb_out=nb_out,
        suffix_rep=rep[1 : p + 1].astype(bool),
        prefix_rep=rep[:p].astype(bool),
    )
