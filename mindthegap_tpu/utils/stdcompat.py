"""ctypes bridge to the native runtime helpers (native/stdcompat.cpp).

The library is compiled on demand (g++, utils/native_build.py). The
main entry point reproduces libstdc++ std::unordered_map iteration order,
which the reference relies on for its multi-target output ordering
(src/Filler.cpp:924-936)."""

from __future__ import annotations

import ctypes

from . import native_build

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    _lib = ctypes.CDLL(native_build.build("stdcompat.cpp", "-O2"))
    _lib.stdmap_iteration_order.restype = ctypes.c_int
    _lib.stdmap_iteration_order.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    return _lib


def unordered_map_order(keys: list[str]) -> list[int]:
    """Indices of `keys` (insertion order) reordered as a libstdc++
    unordered_map<string, V> would iterate them. Duplicates keep their first
    index."""
    if not keys:
        return []
    try:
        lib = _load()
    except Exception:
        # fallback: insertion order (documented approximation when no g++)
        seen = set()
        out = []
        for i, k in enumerate(keys):
            if k not in seen:
                seen.add(k)
                out.append(i)
        return out
    arr = (ctypes.c_char_p * len(keys))(*[k.encode("utf-8") for k in keys])
    out = (ctypes.c_int * len(keys))()
    n = lib.stdmap_iteration_order(arr, len(keys), out)
    return list(out[:n])
