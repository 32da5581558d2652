"""Build-on-first-use for the C++ helpers under native/.

Each shared library is keyed on what produced it: its file name carries a
hash of the source's content, the compile command and the compiler's
version. A library built from another source, with other flags or by
another compiler is never loaded, whatever its mtime; a missing key is
built once and moved into place atomically, so concurrent processes never
load a half-written file. Flags are portable (no -march=native): a library
may run on another machine than the one that built it.
"""

from __future__ import annotations

import functools
import hashlib
import os
import subprocess

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
)

# last build failure per source file (compiler stderr), for diagnostics
errors: dict[str, str] = {}


@functools.cache
def _compiler_version() -> str:
    return subprocess.run(
        ["g++", "--version"], check=True, capture_output=True, text=True
    ).stdout.splitlines()[0]


def build(src_name: str, opt: str = "-O3", libs: tuple[str, ...] = ()) -> str:
    """Path of native/<src_name> compiled as a shared library, building it
    when no library with this source, command and compiler exists.
    Raises (and records the compiler's message in `errors`) on failure."""
    src = os.path.join(NATIVE_DIR, src_name)
    args = [opt, "-shared", "-fPIC"]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update("\0".join([_compiler_version(), *args, *libs]).encode())
    stem = os.path.splitext(src_name)[0]
    lib_path = os.path.join(NATIVE_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        ["g++", *args, "-o", tmp, src, *libs], capture_output=True, text=True
    )
    if proc.returncode != 0:
        errors[src_name] = proc.stderr
        raise RuntimeError(f"building native/{src_name} failed:\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path
