"""Build a kernel source with ``nvcc`` into a shared library and load it.

Each CUDA source under a kernel's ``csrc/`` exposes a plain C interface.
:func:`load` compiles it at first use for Hopper (``sm_90a``) into
``build/repro_torch/`` at the root of the checkout, keyed by a hash of the
source and the flags, and loads it with ``ctypes``.  Nothing is built when a
module is imported, so the CPU-only test runs never need ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

#: flags of every build.  No --use_fast_math: the kernels need correctly
#: rounded division; --fmad=false keeps products and sums separately
#: rounded, as in the plain PyTorch versions they are held against.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


@dataclass(frozen=True)
class Built:
    """A loaded library and how it was built."""

    lib: ctypes.CDLL
    path: Path
    seconds: float      # compile time in this process (0.0 when cached)
    ptxas: str          # nvcc's -Xptxas -v report (registers, smem, spills)


#: one lock per library path: two threads never build the same library,
#: and different sources build in parallel
_LOCKS: dict[Path, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    place."""
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def load(source: Path) -> Built:
    """Compile ``source`` (unless a library of the same content and flags
    is already built) and load it.  Callers keep the result.  Threads
    loading different sources compile them in parallel."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.so"
    report = out.with_suffix(".ptxas.txt")
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(out, threading.Lock())
    with lock:
        seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            report.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, out)
        return Built(ctypes.CDLL(str(out)), out, seconds,
                     report.read_text() if report.exists() else "")
