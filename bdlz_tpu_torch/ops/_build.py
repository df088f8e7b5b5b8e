"""Build the port's CUDA sources into shared libraries and load them.

Route: ``nvcc`` by hand into a shared library with a plain C interface,
loaded with ``ctypes`` — seconds per build, where a source that includes
PyTorch's headers takes minutes.  The library lands in ``build/kernels/``
under the repository root, named by a hash of the source and the flags,
so the first use on a machine builds it and later uses load it.  Nothing
here runs at import time.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

CSRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel
)

#: Flags one source adds to ``NVCC_FLAGS``.  The bounce shoot repeats the
#: plain version's arithmetic operation by operation, so a*b+c must not be
#: contracted into one rounding.
SOURCE_FLAGS = {"bounce_shoot.cu": ("-fmad=false",)}


class Built(NamedTuple):
    path: pathlib.Path
    seconds: float      # compile time; 0.0 when an earlier build was reused
    ptxas_log: str      # what ``-Xptxas -v`` reported
    cached: bool


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source on the machine with the card"
        )
    return nvcc


def library_digest(source: str) -> str:
    """16 hex digits over ``csrc/<source>`` and its nvcc flags: the name of
    its built library, and what keys its numerics."""
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(source, ())
    return hashlib.sha256((CSRC_DIR / source).read_bytes()
                          + " ".join(flags).encode()).hexdigest()[:16]


def build(source: str) -> Built:
    """Compile ``csrc/<source>`` for sm_90a, or reuse the build of the same
    source and flags.  Raises ``RuntimeError`` with nvcc's output on failure."""
    src = CSRC_DIR / source
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(source, ())
    digest = library_digest(source)
    lib = BUILD_DIR / f"{src.stem}-{digest}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        return Built(lib, 0.0, log.read_text() if log.exists() else "", True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [find_nvcc(), *flags, "-o", tmp, str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return Built(lib, time.perf_counter() - t0, proc.stdout + proc.stderr, False)
