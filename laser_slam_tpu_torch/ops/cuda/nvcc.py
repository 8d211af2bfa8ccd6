"""Builds a CUDA source of the package (``csrc/*.cu``, a plain C
interface) with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` beside
the package, keyed by a hash of the source and flags, and loads it with
``ctypes``. A library already built for the same source and flags is
loaded as it is. One lock serialises the builds of a process: the
kernels are first called from more than one thread (the online
session's frontend and its background round)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
BUILD_DIR = PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Held around a check-build-load: by load() and by each wrapper's build(),
# which re-checks its own library under it.
LOCK = threading.RLock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the package's CUDA kernels need the CUDA toolkit")


def load(source: Path, flags: tuple = NVCC_FLAGS) -> tuple[ctypes.CDLL, str]:
    """The library built from ``source`` with ``flags``, and ``nvcc``'s
    output (its ptxas register / shared-memory report; empty when the
    library was already built)."""
    src = Path(source).read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{Path(source).stem}_{digest}.so"
    log = ""
    with LOCK:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.run(
                [_nvcc(), *flags, "-o", str(tmp), str(source)], capture_output=True, text=True,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {source}:\n{log}")
            os.replace(tmp, so)
        return ctypes.CDLL(str(so)), log
