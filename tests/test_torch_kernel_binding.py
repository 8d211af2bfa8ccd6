"""The one binding of the port's CUDA kernels (``ops/cuda/nvcc.py``) on the
CPU: a launch that fails raises with the library's own error string, the
five operators are registered whichever wrapper is imported first, and no
other module of the package makes a dispatcher library or declares a C
entry. The build itself is held by
``test_torch_correlative_sparse.py::test_first_builds_from_two_threads_run_nvcc_once``;
the kernels run only on the card (``test_torch_cuda.py``)."""

import ast
import itertools
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from laser_slam_tpu_torch.ops.cuda import nvcc

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "laser_slam_tpu_torch"
WRAPPERS = ("psm_kernel", "correlative_kernel", "raycast_kernel", "icp_nearest_kernel")
OPERATORS = ("corr_volume", "ray_march", "psm_match", "psm_chain", "nearest_two")


@pytest.mark.parametrize("rc", [0, 700])
def test_launch_passes_device_and_stream_and_raises_on_an_error_code(monkeypatch, rc):
    calls = []

    class Library:     # stands in for a library nvcc built
        def k_launch(self, *args):
            calls.append(args)
            return rc

        def k_error_string(self, code):
            return f"error {code}: an illegal memory access was encountered".encode()

    kernel = nvcc.Kernel(Path("k.cu"), {"k_launch": []}, "k_error_string")
    kernel.lib = Library()
    monkeypatch.setattr(nvcc.torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=77 + device.index))
    if rc:
        with pytest.raises(RuntimeError, match="k_launch failed: error 700: an illegal memory"):
            kernel.launch("k_launch", 1, 2.5, device=torch.device("cuda", 3))
    else:
        kernel.launch("k_launch", 1, 2.5, device=torch.device("cuda", 3))
    assert calls == [(1, 2.5, 3, 80)]


@pytest.mark.parametrize("order", list(itertools.permutations(WRAPPERS)))
def test_any_import_order_registers_every_operator(order):
    """Every wrapper registers through ``nvcc``, which alone defines the
    namespace, so no order of first imports can define it twice."""
    code = "\n".join([
        "import torch",
        *(f"import laser_slam_tpu_torch.ops.cuda.{m}" for m in order),
        f"for op in {OPERATORS!r}:",
        "    assert torch._C._dispatch_has_kernel_for_dispatch_key(",
        "        f'laser_slam_tpu_torch::{op}', 'CUDA'), op",
        "    getattr(torch.ops.laser_slam_tpu_torch, op).default",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _library_calls(tree):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call) and (
        getattr(n.func, "attr", None) == "Library" or getattr(n.func, "id", None) == "Library")]


def _argtypes_stores(tree):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and n.attr == "argtypes" and isinstance(n.ctx, ast.Store)]


@pytest.mark.parametrize("find,owners", [
    (_library_calls, {"ops/cuda/nvcc.py"}),
    (_argtypes_stores, {"ops/cuda/nvcc.py", "native/api.py"}),
])
def test_only_the_binding_registers_operators_and_declares_entries(find, owners):
    found = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")
             if find(ast.parse(p.read_text()))}
    assert found == owners
