"""Builds a CUDA source of the package (``csrc/*.cu``, a plain C
interface) with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` beside
the package, keyed by a hash of the source and flags, and loads it with
``ctypes``. A library already built for the same source and flags is
loaded as it is. One lock serialises the builds of a process: the
kernels are first called from more than one thread (the online
session's frontend and its background round).

Every kernel of the package is bound the same way: a :class:`Kernel`
declares its library's C entries, builds it at first use and launches an
entry on PyTorch's current stream; :func:`register` makes that launch the
CUDA kernel of an operator in the package's one dispatcher namespace,
``laser_slam_tpu_torch``."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[2]
BUILD_DIR = PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Held around a check-build-load: by load() and by Kernel.build(), which
# re-checks its own library under it.
LOCK = threading.RLock()

# The package's operators: the one library that defines the namespace
# (a second "DEF" of it fails at import).
_OPS = torch.library.Library("laser_slam_tpu_torch", "DEF")


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


def register(schema: str, launch) -> None:
    """Defines the operator ``laser_slam_tpu_torch::<schema>`` and makes
    ``launch`` its CUDA kernel. Under ``torch.profiler`` a kernel launched
    inside an operator is linked to it, and through it to the program's
    span around the call, as PyTorch's own kernels are; a launch from
    outside any operator is linked to none."""
    _OPS.define(schema)
    _OPS.impl(schema.split("(", 1)[0], launch, "CUDA")


class Kernel:
    """The library built from ``source``, loaded at first use, with its C
    entries declared from ``signatures`` (entry name -> ``argtypes``;
    every entry returns an int). A launch entry takes the device index
    and a stream last and returns a CUDA error code, whose text the
    library's ``error_string(code)`` entry gives."""

    def __init__(self, source: Path, signatures: dict[str, list], error_string: str):
        self.source = Path(source)
        self.signatures = signatures
        self.error_string = error_string
        self.lib: ctypes.CDLL | None = None
        self.build_log = ""   # nvcc's output (ptxas register / shared-memory report)

    def build(self, flags: tuple = NVCC_FLAGS) -> float:
        """Compile (if needed, with ``nvcc`` ``flags``) and load the
        library; returns the seconds spent, 0 when it was already loaded."""
        with LOCK:
            if self.lib is not None:
                return 0.0
            t0 = time.perf_counter()
            lib, log = load(self.source, flags)
            for name, argtypes in self.signatures.items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
            err = getattr(lib, self.error_string)
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self.lib, self.build_log = lib, log
            return time.perf_counter() - t0

    def install(self, other: Kernel) -> None:
        """Launch from ``other``'s library from now on (building it first
        if it is not yet): a copy of this source instrumented or built
        with other flags, for probing."""
        other.build()
        with LOCK:
            self.lib, self.build_log = other.lib, other.build_log

    def launch(self, entry: str, *args, device: torch.device) -> None:
        """Calls ``entry`` with ``args``, the index of CUDA ``device`` and
        its current stream; raises ``RuntimeError`` with the library's
        error string when it returns non-zero."""
        if self.lib is None:
            self.build()
        index = device.index if device.index is not None else torch.cuda.current_device()
        rc = getattr(self.lib, entry)(*args, index, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{entry} failed: {getattr(self.lib, self.error_string)(rc).decode()}")
