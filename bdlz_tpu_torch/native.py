"""ctypes bindings to the native IO runtime (``native/bdlz_io.cpp``).

Counterpart of ``bdlz_tpu/native.py``: the same two-call CSV protocol,
error classes and messages.  The port builds the shared library itself,
with ``g++``, into ``build/native/`` under the repository root beside the
CUDA kernels (``ops/_build.py``), named by a hash of the source and the
flags; it never runs ``native/Makefile``, whose output belongs to the JAX
package.  Nothing is built at import time.

A machine with no compiler keeps the NumPy parse of
``lz/profile._read_csv``, which gives the same bits (this is host IO, no
device path); :func:`native_available` says which parser a run gets.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
SOURCE = REPO / "native" / "bdlz_io.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_ERRORS = {
    -1: "could not open file",
    -2: "empty file or missing header",
    -3: "malformed row (wrong column count or non-numeric cell)",
    -4: "header too long",
    -5: "row count changed between probe and fill",
}


class NativeParseError(ValueError):
    pass


def build_library() -> pathlib.Path:
    """Compile ``native/bdlz_io.cpp`` with g++, or reuse the build of the
    same source and flags.  Raises ``RuntimeError`` on failure."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libbdlz_io-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return None
    lib.bdlz_csv_dims.restype = ctypes.c_int
    lib.bdlz_csv_dims.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.bdlz_csv_fill.restype = ctypes.c_int
    lib.bdlz_csv_fill.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_long, ctypes.c_int,
    ]
    return lib


def native_available() -> bool:
    """True when the native parser is built and loaded on this machine."""
    return _load() is not None


def read_csv_native(path: str) -> Tuple[list, np.ndarray]:
    """(column_names, data[rows, cols]) via the native parser.

    Raises NativeParseError on malformed input, OSError if the library is
    unavailable (callers fall back to NumPy).
    """
    lib = _load()
    if lib is None:
        raise OSError("native IO library unavailable")
    rows = ctypes.c_long()
    cols = ctypes.c_int()
    header = ctypes.create_string_buffer(1 << 15)
    rc = lib.bdlz_csv_dims(path.encode(), ctypes.byref(rows), ctypes.byref(cols),
                           header, len(header))
    if rc != 0:
        raise NativeParseError(f"{path}: {_ERRORS.get(rc, f'error {rc}')}")
    data = np.empty((rows.value, cols.value), dtype=np.float64)
    rc = lib.bdlz_csv_fill(path.encode(), data, rows.value, cols.value)
    if rc != 0:
        raise NativeParseError(f"{path}: {_ERRORS.get(rc, f'error {rc}')}")
    names = [c.strip() for c in header.value.decode().split(",")]
    return names, data
