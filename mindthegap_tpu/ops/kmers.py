"""K-mer extraction and bit-twiddling on packed 2-bit words.

A k-mer (k <= 32) is a uint64 holding 2k bits, first base most significant —
identical bit layout to the reference's ``Kmer<span>::Type`` for span 64
(reference src/FindSNP.hpp:87-96 ``mutate_kmer``: base at 1-based position
``pos`` from the start lives at bit offset ``2*(k-pos)``; ``kmer & 3`` is the
last base). Encoding A=0 C=1 T=2 G=3, so complement is ``x ^ 0b10`` per base.

Every function exists in a numpy flavor (host, exact oracle) and works
unchanged under jax.numpy for the device path (pass ``xp=jnp``).
"""

from __future__ import annotations

import numpy as np

from ..utils import dna

_COMP_MASK = np.uint64(0xAAAAAAAAAAAAAAAA)  # 0b10 repeated: per-base complement

_M1 = np.uint64(0x3333333333333333)
_M2 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M3 = np.uint64(0x00FF00FF00FF00FF)
_M4 = np.uint64(0x0000FFFF0000FFFF)
_M5 = np.uint64(0x00000000FFFFFFFF)


def kmer_mask(k: int) -> np.uint64:
    """(1 << 2k) - 1 without overflow at k=32."""
    if k == 32:
        return np.uint64(0xFFFFFFFFFFFFFFFF)
    return np.uint64((1 << (2 * k)) - 1)


def revcomp_u64(kmer, k: int, xp=np):
    """Reverse-complement of packed k-mer(s). Works for scalars and arrays,
    numpy or jax.numpy."""
    x = kmer ^ _COMP_MASK  # complement every base (A<->T, C<->G)
    # reverse 2-bit groups within the 64-bit word
    x = ((x >> np.uint64(2)) & _M1) | ((x & _M1) << np.uint64(2))
    x = ((x >> np.uint64(4)) & _M2) | ((x & _M2) << np.uint64(4))
    x = ((x >> np.uint64(8)) & _M3) | ((x & _M3) << np.uint64(8))
    x = ((x >> np.uint64(16)) & _M4) | ((x & _M4) << np.uint64(16))
    x = ((x >> np.uint64(32)) & _M5) | ((x & _M5) << np.uint64(32))
    # the k-mer now sits in the high 2k bits; shift it back down
    return x >> np.uint64(64 - 2 * k)


def canonical_u64(fwd, k: int, xp=np):
    rc = revcomp_u64(fwd, k, xp)
    return xp.minimum(fwd, rc)


def kmers_from_codes(codes: np.ndarray, k: int):
    """Rolling forward k-mers over a code array (host, numpy).

    Returns (fwd[N-k+1] uint64, valid[N-k+1] bool). A k-mer is valid iff all
    its k bases are ACGT — matching the reference iterator's ``isValid()``
    (used at src/FindBreakpoints.hpp:426).
    """
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    lib = _load_native()
    if lib is not None:
        import ctypes

        codes_c = np.ascontiguousarray(codes, np.uint8)
        npos = n - k + 1
        fwd = np.empty(npos, np.uint64)
        valid = np.empty(npos, np.uint8)
        lib.extract_fwd(
            codes_c.ctypes.data_as(ctypes.c_void_p), n, k,
            fwd.ctypes.data_as(ctypes.c_void_p), valid.ctypes.data_as(ctypes.c_void_p),
        )
        return fwd, valid.astype(bool)
    bad = codes == dna.INVALID
    c = np.where(bad, 0, codes).astype(np.uint64)
    npos = n - k + 1
    # prefix "polynomial" trick: fwd[i] = sum c[i+j] << 2(k-1-j)
    # done with a simple rolling loop over k using vectorized shifts is O(k·n);
    # use cumulative packing instead: O(n) passes of log structure not needed
    # for host oracle. Vectorized O(k) loop:
    fwd = np.zeros(npos, np.uint64)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | c[j : j + npos]
    # validity: no invalid base in window
    badc = np.cumsum(bad.astype(np.int64))
    badc = np.concatenate([[0], badc])
    valid = (badc[k:] - badc[:-k]) == 0
    return fwd, valid


_KM_LIB = None
_KM_FAILED = False


def _load_native():
    """native/kmers.cpp: scalar rolling extraction (~80x the numpy loop)."""
    global _KM_LIB, _KM_FAILED
    if _KM_LIB is not None or _KM_FAILED:
        return _KM_LIB
    import ctypes

    from ..utils import native_build

    try:
        lib = ctypes.CDLL(native_build.build("kmers.cpp"))
        lib.extract_fwd.restype = None
        lib.extract_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.extract_canonical.restype = ctypes.c_int64
        lib.extract_canonical.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        _KM_LIB = lib
    except Exception:
        _KM_FAILED = True
        _KM_LIB = None
    return _KM_LIB


def canonical_compact(codes: np.ndarray, k: int) -> np.ndarray:
    """All valid canonical k-mers of a code array, compacted (the counting
    stream). Native scalar pass when available, numpy fallback otherwise."""
    lib = _load_native()
    if lib is not None and k <= 32:
        import ctypes

        codes_c = np.ascontiguousarray(codes, np.uint8)
        n = codes_c.shape[0]
        if n < k:
            return np.zeros(0, np.uint64)
        out = np.empty(n - k + 1, np.uint64)
        m = lib.extract_canonical(codes_c.ctypes.data_as(ctypes.c_void_p), n, k,
                                  out.ctypes.data_as(ctypes.c_void_p))
        return out[:m]
    fwd, valid = kmers_from_codes(codes, k)
    if fwd.size == 0:
        return fwd
    return canonical_u64(fwd[valid], k)


def kmer_to_str(kmer: int, k: int) -> str:
    out = []
    km = int(kmer)
    for i in range(k):
        out.append(dna.NUC_CHARS[(km >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def str_to_kmer(s: str) -> int:
    v = 0
    for ch in s:
        code = int(dna.seq_to_codes(ch)[0])
        if code == dna.INVALID:
            raise ValueError(f"invalid base {ch!r}")
        v = (v << 2) | code
    return v


def _mask_int(k: int) -> int:
    """(1 << 2k) - 1 as a python int (any k; the point-query helpers below
    run on python ints so k > 32 spans work unchanged)."""
    return (1 << (2 * k)) - 1


def mutate_kmer(kmer: int, nuc: int, pos: int, k: int) -> int:
    """Set base at 1-based position ``pos`` (from the start) to ``nuc``
    (reference src/FindSNP.hpp:87-96)."""
    p = k - pos
    reset = ~(3 << (p * 2))
    return (int(kmer) & reset & _mask_int(k)) | (nuc << (p * 2))


def shift_left(kmer: int, nuc: int, k: int) -> int:
    """Append base on the right (out-neighbor): drop leftmost base."""
    return ((int(kmer) << 2) | nuc) & _mask_int(k)


def shift_right(kmer: int, nuc: int, k: int) -> int:
    """Prepend base on the left (in-neighbor): drop rightmost base."""
    return (int(kmer) >> 2) | (nuc << (2 * (k - 1)))
