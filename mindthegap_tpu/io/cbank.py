"""ctypes bridge to the native FASTA/FASTQ parser (native/fastx.cpp).

Returns records as (headers, packed code arrays) without python-level string
processing on the sequence path. Falls back to the pure-python bank when the
native library cannot be built."""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import native_build

_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(native_build.build("fastx.cpp", "-O2", ("-lz",)))
        lib.fastx_parse.restype = ctypes.c_void_p
        lib.fastx_parse.argtypes = [ctypes.c_char_p]
        lib.fastx_n.restype = ctypes.c_int64
        lib.fastx_n.argtypes = [ctypes.c_void_p]
        lib.fastx_codes_size.restype = ctypes.c_int64
        lib.fastx_codes_size.argtypes = [ctypes.c_void_p]
        lib.fastx_headers_size.restype = ctypes.c_int64
        lib.fastx_headers_size.argtypes = [ctypes.c_void_p]
        lib.fastx_codes.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.fastx_codes.argtypes = [ctypes.c_void_p]
        lib.fastx_offsets.restype = ctypes.POINTER(ctypes.c_int64)
        lib.fastx_offsets.argtypes = [ctypes.c_void_p]
        lib.fastx_headers.restype = ctypes.POINTER(ctypes.c_char)
        lib.fastx_headers.argtypes = [ctypes.c_void_p]
        lib.fastx_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib_failed = True
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def parse_codes(path: str):
    """Parse one FASTA/FASTQ(.gz) file natively.

    Returns (headers: list[str], codes: uint8 array, offsets: int64 array
    [n+1]) or None if the native parser is unavailable/failed."""
    lib = _load()
    if lib is None:
        return None
    h = lib.fastx_parse(path.encode())
    if not h:
        return None
    try:
        n = lib.fastx_n(h)
        csize = lib.fastx_codes_size(h)
        hsize = lib.fastx_headers_size(h)
        codes = np.ctypeslib.as_array(lib.fastx_codes(h), shape=(csize,)).copy()
        offsets = np.ctypeslib.as_array(lib.fastx_offsets(h), shape=(n + 1,)).copy()
        raw = ctypes.string_at(lib.fastx_headers(h), hsize)
        headers = raw.decode("utf-8", "replace").split("\0")[:-1] if hsize else []
        return headers, codes, offsets
    finally:
        lib.fastx_free(h)
