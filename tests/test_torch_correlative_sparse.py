"""The sparse correlative score-volume kernel
(``laser_slam_tpu_torch/csrc/correlative_kernel.cu``) as a numpy
transcription, held bit for bit against a transcription of the dense
depthwise convolution it replaces, and against the port's plain version
``correlative._score_volume_conv``; and the kernel wrapper's checks.

The kernel sorts a (row, rotation)'s cell ids, merges equal ids into one
cell with its count, and adds ``count · plane`` at every shift over the
unique cells in ascending id order, one float32 multiply-add a term. The
dense convolution adds ``raster · padded plane`` over every raster cell in
row-major order, one multiply-add a term. Its zero counts and zero padding
add exact zeros, so the two must agree bit for bit: that is what the first
test holds. The kernel itself is held to the plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu_torch.ops import correlative as tc
from laser_slam_tpu_torch.ops.cuda import correlative_kernel as ck

HALF_EXTENT, RES = 1.2, 0.1    # a 24 × 24 raster
N_STEPS = 3


def fma32(w, x, v):
    """float32 ``fmaf(w, x, v)``: the exact sum in float64, rounded once.
    Exact here: ``w`` is a count below 2**6, ``x`` a float32 of at least
    2**-10 (or 0), ``v`` a float32 below 2**7, so ``w·x + v`` spans fewer
    than 53 bits."""
    return np.float32(np.float64(w) * np.float64(x) + np.float64(v))


def sparse_transcription(planes, cells, n_steps):
    """``corr_volume_kernel`` on numpy arrays: planes ``[C, B, G, G]``
    float32, cells ``[B, K, N]`` int (negative: dropped)."""
    c_planes, b, g, _ = planes.shape
    k, t = cells.shape[1], 2 * n_steps + 1
    out = np.zeros((c_planes, b, k, t, t), np.float32)
    for r in range(b):
        for q in range(k):
            ids = np.sort(cells[r, q][cells[r, q] >= 0])
            uniq, counts = np.unique(ids, return_counts=True)     # ascending
            for a in range(t):
                for c in range(t):
                    for p in range(c_planes):
                        v = np.float32(0.0)
                        for cell, n in zip(uniq, counts):
                            y, x = cell // g + a - n_steps, cell % g + c - n_steps
                            if 0 <= y < g and 0 <= x < g:
                                v = fma32(n, planes[p, r, y, x], v)
                        out[p, r, q, a, c] = v
    return out


def dense_transcription(planes, cells, n_steps):
    """The depthwise convolution of the plain version as PyTorch's generic
    kernel accumulates it: at every output, ``value = fma(weight, input,
    value)`` over the whole count raster, row-major, zero weights and zero
    padding included."""
    c_planes, b, g, _ = planes.shape
    k, t = cells.shape[1], 2 * n_steps + 1
    out = np.zeros((c_planes, b, k, t, t), np.float32)
    pad = np.pad(planes, ((0, 0), (0, 0), (n_steps, n_steps), (n_steps, n_steps)))
    for r in range(b):
        for q in range(k):
            ids = cells[r, q][cells[r, q] >= 0]
            raster = np.bincount(ids, minlength=g * g).astype(np.float32)
            for p in range(c_planes):
                v = np.zeros((t, t), np.float32)
                for kh in range(g):
                    for kw in range(g):
                        w = raster[kh * g + kw]
                        win = pad[p, r, kh:kh + t, kw:kw + t]
                        v = np.float32(np.float64(w) * win.astype(np.float64)
                                       + v.astype(np.float64)).astype(np.float32)
                out[p, r, q] = v
    return out


def clouds():
    """Three rows of 40 points: points doubled up in one cell, points far
    off the raster, an all-invalid row; rotations across ±π."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.0, 1.0, (3, 40, 2)).astype(np.float32)
    pts[:, 20:26] = pts[:, 10:16]                 # the same cells twice
    pts[0, 30] = pts[0, 31] = pts[0, 32] = pts[0, 5]   # four points in one cell
    pts[1, 35:] = [[5.0, 0.0], [0.0, -4.0], [3.0, 3.0], [1.19, 0.0], [-1.21, 0.5]]
    ok = np.ones((3, 40), bool)
    ok[0, 38:] = False
    ok[2] = False                                  # an all-invalid row
    ref = rng.uniform(-1.1, 1.1, (3, 60, 2)).astype(np.float32)
    grid = tc.build_likelihood_grid_points(
        torch.from_numpy(ref), torch.ones(3, 60, dtype=torch.bool),
        res=RES, half_extent=HALF_EXTENT)
    thetas = torch.tensor([[-np.pi, -1.0, 0.0, 2.0, np.pi]] * 3, dtype=torch.float32)
    thetas[1] += 0.03
    base = torch.tensor([[0.0, 0.0], [0.15, -0.1], [0.0, 0.0]])
    return grid, torch.from_numpy(pts), torch.from_numpy(ok), thetas, base


@pytest.mark.parametrize("overlap_norm", [False, True])
def test_sparse_sum_is_the_dense_convolution_bit_for_bit(overlap_norm):
    grid, pts, ok, thetas, base = clouds()
    g = grid.shape[-1]
    ix, iy, inb = tc._rotated_cells(pts, ok, thetas, base, RES, HALF_EXTENT, g)
    planes = torch.stack([grid, tc._cover(grid, RES, 1.5)]) if overlap_norm else grid[None]
    cells = torch.where(inb, iy * g + ix, -1).to(torch.int32).numpy()
    pl = planes.numpy()
    assert pl[pl > 0].min() >= 2.0 ** -10          # fma32's exactness bound
    assert (np.stack([np.bincount(r[r >= 0]).max() for r in cells[:2].reshape(-1, 40)]) > 1).all()
    assert (cells[1] < 0).any() and (cells[2] < 0).all()

    sparse = sparse_transcription(pl, cells, N_STEPS)
    dense = dense_transcription(pl, cells, N_STEPS)
    np.testing.assert_array_equal(sparse, dense)
    assert np.abs(sparse[:, 2]).max() == 0.0        # the all-invalid row
    # The plain version (the CPU's convolution, another summation order).
    plain = tc._score_volume_conv(planes, ix, iy, inb, N_STEPS).numpy()
    np.testing.assert_allclose(sparse, plain, rtol=1e-6, atol=1e-6)
    assert sparse.max() > 1.0


def test_the_wrapper_rejects_what_the_kernel_does_not_take():
    """Every check raises before the library is built or a launch counted."""
    planes = torch.zeros(1, 2, 8, 8)
    cells = torch.zeros(2, 3, 5, dtype=torch.int32)
    before = ck.score_volume_sparse.launches
    bad = [
        (planes.double(), cells),                                   # float64 grids
        (planes, cells.long()),                                     # int64 ids
        (planes, torch.zeros(2, 3, ck.MAX_POINTS + 1, dtype=torch.int32)),   # too many points
        (planes.transpose(2, 3), cells),                            # not contiguous
        (planes, cells[:, :, ::2]),                                 # not contiguous
        (torch.zeros(3, 2, 8, 8), cells),                           # three planes
        (torch.zeros(1, 2, 8, 9), cells),                           # not square
        (planes, cells[:1]),                                        # rows differ
        (planes, cells),                                            # CPU tensors
    ]
    for p, c in bad:
        with pytest.raises(ValueError):
            ck.score_volume_sparse(p, c, N_STEPS)
    assert ck.score_volume_sparse.launches == before


def test_first_builds_from_two_threads_run_nvcc_once(tmp_path, monkeypatch):
    """The online session first calls the kernels from its frontend and its
    background round at once: two builds of one kernel, and a kernel of
    the same source, must share one ``nvcc`` run and one library, each
    loaded once and its entries declared from the kernel's table."""
    import ctypes
    import threading
    import time
    from types import SimpleNamespace

    from laser_slam_tpu_torch.ops.cuda import nvcc

    runs, loads = [], []

    def fake_nvcc(cmd, **kw):
        runs.append(cmd)
        time.sleep(0.2)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"lib")
        return SimpleNamespace(returncode=0, stdout="ptxas info", stderr="")

    class FakeLibrary:
        def __init__(self, path):
            loads.append(path)
            self.path = path
            self.k_launch, self.k_error_string = SimpleNamespace(), SimpleNamespace()

    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(nvcc, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nvcc.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(nvcc.ctypes, "CDLL", FakeLibrary)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel")
    a, b = (nvcc.Kernel(src, {"k_launch": [ctypes.c_void_p, ctypes.c_int]}, "k_error_string")
            for _ in range(2))
    seconds = []
    threads = [threading.Thread(target=lambda k=k: seconds.append(k.build())) for k in (a, a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(runs) == 1 and len(loads) == 2 and a.lib.path == b.lib.path
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == [a.lib.path.rsplit("/", 1)[1]]
    assert seconds.count(0.0) == 1 and "ptxas info" in a.build_log + b.build_log
    assert a.lib.k_launch.argtypes == [ctypes.c_void_p, ctypes.c_int]
    assert a.lib.k_launch.restype is ctypes.c_int
    assert (a.lib.k_error_string.argtypes, a.lib.k_error_string.restype) == (
        [ctypes.c_int], ctypes.c_char_p)
