"""The scatter projection of the fused PSM CUDA kernel
(``laser_slam_tpu_torch/csrc/psm_kernel.cu``, device function ``project``)
as a numpy transcription, held for exact equality against the port's dense
``scan_project``.

The kernel's thread of pair ``i`` visits only the bins its bearing span can
cover (found from the grid's step, a sixteenth of a bin wider on each side,
decided by the dense form's own comparison against the bearings) and reduces a packed
``(ordered range bits << 32 | pair index)`` with an unsigned minimum per
bin, starting from ``(EMPTY_RANGE, pair 0)``. That must give the dense
form's result bit for bit: the least range, the first pair on ties, that
pair's facing as the occlusion flag. The transcription starts from the same
per-pair quantities (``project.pair_geometry``) as the dense form, so the
two differ in the reduction rule alone. The kernel itself is held to the
plain matcher on the card in tests/test_torch_cuda.py.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on the CPU; one intra-op thread each
# keeps torch's thread pools from oversubscribing it.
torch.set_num_threads(1)

from laser_slam_tpu_torch.core.scan import PRESETS, Scan
from laser_slam_tpu_torch.ops import preprocess as pp
from laser_slam_tpu_torch.ops import project as proj
from laser_slam_tpu_torch.ops.cuda import probe

NAMES = ["LMS211", "LMS511", "LMS151"]
EMPTY = np.float32(proj.EMPTY_RANGE)
BIN_MARGIN = np.float32(0.0625)    # kBinMargin of the kernel


def pack_key(v, pair):
    """``pack_key`` of the kernel: float32 bits that order as the float
    does (negatives too, -0 as +0), above the pair index."""
    v = np.float32(v) + np.float32(0.0)
    b = int(np.asarray(v, np.float32).view(np.uint32))
    b = (~b & 0xFFFFFFFF) if b & 0x80000000 else (b | 0x80000000)
    return (b << 32) | int(pair)


def key_value(k):
    b = k >> 32
    b = (b & 0x7FFFFFFF) if b & 0x80000000 else (~b & 0xFFFFFFFF)
    return np.asarray(b, np.uint32).view(np.float32)[()]


def scatter_project(fi, g, dfi):
    """One scan: ``fi [N]`` float32 bearings, ``g`` a ``PairGeometry`` of
    numpy ``[N]`` arrays. Returns ``(new_r, empty, occluded, max_span)``."""
    n = fi.size
    inv_dfi = np.float32(1.0) / np.float32(dfi)
    key = [pack_key(EMPTY, 0)] * n
    cover = np.zeros(n, bool)
    max_span = 0
    for i in range(1, n):          # pair 0 is never valid
        if not g.ok[i]:
            continue
        lo, hi = g.lo[i], g.hi[i]
        flo = np.ceil((lo - fi[0]) * inv_dfi - BIN_MARGIN)
        fhi = np.floor((hi - fi[0]) * inv_dfi + BIN_MARGIN)
        jlo = int(max(flo, np.float32(0.0)))
        jhi = int(min(fhi, np.float32(n - 1)))
        # The candidates leave out no bin that the dense form's mask covers.
        covered = np.nonzero((fi >= lo) & (fi <= hi))[0]
        assert covered.size == 0 or (jlo <= covered[0] and covered[-1] <= jhi)
        span = 0
        for j in range(jlo, jhi + 1):
            f = fi[j]
            if f >= lo and f <= hi:
                u = (f - g.phi0[i]) / g.dphi[i]
                v = g.rr0[i] + g.drr[i] * u
                assert u.dtype == np.float32 and v.dtype == np.float32
                cover[j] = True
                span += 1
                if v == v:
                    key[j] = min(key[j], pack_key(v, i))
        max_span = max(max_span, span)
    new_r = np.asarray([key_value(k) for k in key], np.float32)
    win = np.asarray([k & 0xFFFFFFFF for k in key])
    return new_r, ~cover, cover & g.occl[win], max_span


def check_geometry(fi, g, dfi):
    """Scatter against dense on a batch ``[B, N]`` of pair geometries;
    returns the widest span seen."""
    dense = proj.project_dense(fi, g)
    widest = 0
    for b in range(g.ok.shape[0]):
        gb = proj.PairGeometry(*(x[b].numpy() for x in g))
        new_r, empty, occluded, span = scatter_project(fi.numpy(), gb, dfi)
        np.testing.assert_array_equal(new_r, dense.new_r[b].numpy())
        np.testing.assert_array_equal(empty, dense.empty[b].numpy())
        np.testing.assert_array_equal(occluded, dense.occluded[b].numpy())
        widest = max(widest, span)
    return dense, widest


def check_scans(model, ranges, poses):
    scans = pp.preprocess(torch.as_tensor(np.asarray(ranges, np.float32)), model)
    fi = model.bearings(torch.float32)
    g = proj.pair_geometry(model, scans, torch.as_tensor(np.asarray(poses, np.float32)))
    dense, widest = check_geometry(fi, g, model.dfi)
    # project_dense on pair_geometry is scan_project itself.
    whole = proj.scan_project(model, scans, torch.as_tensor(np.asarray(poses, np.float32)))
    for a, b in zip(dense, whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    return dense, widest


@pytest.mark.parametrize("name", NAMES)
def test_scatter_equals_dense_on_box_room(room, name):
    model = PRESETS[name]
    rng = np.random.default_rng(31)
    k = 24
    world = np.stack([rng.uniform(-2.0, 4.0, k), rng.uniform(-3.0, 3.0, k),
                      rng.uniform(-np.pi, np.pi, k)], 1)
    r = np.stack([room(model, p) for p in world])
    r += rng.normal(0, 0.01, r.shape).astype(np.float32)
    poses = np.concatenate([rng.normal(0, 0.3, (k, 2)), rng.normal(0, 0.3, (k, 1))], 1)
    poses[0] = 0.0    # the first projection of a match from the zero prior
    dense, _ = check_scans(model, r, poses)
    assert dense.empty.any() and (~dense.bad).sum() > 0.4 * dense.bad.numel()


@pytest.mark.parametrize("name", NAMES)
def test_scatter_equals_dense_on_close_point(room, name):
    """A surface at 0.3 m seen from a pose beside it: its pairs stretch
    over tens of bins, which the scatter loops over and does not cap."""
    model = PRESETS[name]
    r = room(model, (0.0, 0.0, 0.0))[None].copy()
    mid = model.n_beams // 2
    r[0, mid - 3: mid + 3] = 0.3
    # The pose puts the target's origin just in front of the chord between
    # beams mid-1 and mid, which then spans most of a half turn.
    ang = model.fi_min + (mid - 0.5) * model.dfi
    pose = [[-0.2999 * math.cos(ang), -0.2999 * math.sin(ang), 0.0]]
    _, widest = check_scans(model, r, pose)
    assert widest > 32


@pytest.mark.parametrize("name", NAMES)
def test_scatter_equals_dense_on_all_bad_scan(name):
    model = PRESETS[name]
    r = np.full((1, model.n_beams), model.max_range + 1.0, np.float32)
    dense, widest = check_scans(model, r, [[0.1, 0.2, 0.05]])
    assert dense.empty.all() and widest == 0
    assert (dense.new_r == proj.EMPTY_RANGE).all()


def test_scatter_equals_dense_across_third_quadrant_lift(room):
    """A 270° scan turned so that its span crosses -pi: bearings in the
    third quadrant are lifted by 2 pi and pairs across the seam drop out."""
    model = PRESETS["LMS151"]
    r = np.stack([room(model, (0.5, -0.5, 0.3)), room(model, (1.0, 1.0, -2.0))])
    poses = [[0.2, -0.1, 0.6], [-0.3, 0.2, -0.9]]
    dense, _ = check_scans(model, r, poses)
    scans = pp.preprocess(torch.as_tensor(r), model)
    g = proj.pair_geometry(model, scans, torch.as_tensor(np.asarray(poses, np.float32)))
    assert (g.hi > math.pi).any()                       # lifted bearings exist
    assert (~dense.bad).sum() > 0.4 * dense.bad.numel()


def hand_geometry(model, pairs):
    """A ``[1, N]`` geometry with only the given pairs valid:
    ``{i: (phi0, phi, rr0, rr)}``."""
    n = model.n_beams
    f = lambda v: torch.full((1, n), v, dtype=torch.float32)
    phi0, phi, rr0, rr = f(0.0), f(0.0), f(1.0), f(1.0)
    ok = torch.zeros(1, n, dtype=torch.bool)
    for i, (a0, a1, r0, r1) in pairs.items():
        phi0[0, i], phi[0, i], rr0[0, i], rr[0, i], ok[0, i] = a0, a1, r0, r1, True
    dphi = phi - phi0
    return proj.PairGeometry(
        ok=ok, lo=torch.minimum(phi0, phi), hi=torch.maximum(phi0, phi),
        occl=phi <= phi0, phi0=phi0,
        dphi=torch.where(torch.abs(dphi) < 1e-9, 1e-9, dphi), rr0=rr0, drr=rr - rr0)


@pytest.mark.parametrize("name", NAMES)
def test_scatter_tie_goes_to_the_first_pair(name):
    """Two pairs give one bin the same range; the first decides occlusion.
    The later pair faces the sensor, the earlier one is back-facing."""
    model = PRESETS[name]
    fi = model.bearings(torch.float32)
    j = model.n_beams // 3
    a, b = float(fi[j - 1]), float(fi[j + 1])
    g = hand_geometry(model, {5: (b, a, 2.0, 2.0), 9: (a, b, 2.0, 2.0)})
    dense, _ = check_geometry(fi, g, model.dfi)
    assert dense.new_r[0, j] == 2.0 and dense.occluded[0, j]
    g = hand_geometry(model, {5: (a, b, 2.0, 2.0), 9: (b, a, 2.0, 2.0)})
    dense, _ = check_geometry(fi, g, model.dfi)
    assert dense.new_r[0, j] == 2.0 and not dense.occluded[0, j]


@pytest.mark.parametrize("name", NAMES)
def test_scatter_covered_range_at_or_above_empty(name):
    """A covering pair whose range reaches EMPTY_RANGE loses the tie to
    pair 0, which is never valid: the bin reads EMPTY_RANGE, is not empty,
    and takes pair 0's facing. A negative range orders below every other."""
    model = PRESETS[name]
    fi = model.bearings(torch.float32)
    j = model.n_beams // 2
    a, b = float(fi[j - 1]), float(fi[j + 2])
    for far in (100.0, 250.0):
        g = hand_geometry(model, {7: (a, b, far, far)})
        dense, _ = check_geometry(fi, g, model.dfi)
        assert dense.new_r[0, j] == proj.EMPTY_RANGE and not dense.empty[0, j]
        assert dense.occluded[0, j] == g.occl[0, 0]
    g = hand_geometry(model, {7: (a, b, 3.0, 3.0), 8: (a, b, -0.5, -0.25)})
    dense, _ = check_geometry(fi, g, model.dfi)
    assert dense.new_r[0, j] < 0.0


def test_probe_counters_fit_the_kernel_source():
    """The cycle-counter probe patches a copy of the kernel source at fixed
    anchors; each must still be there exactly once."""
    src = probe.instrumented_source()
    assert src.count("TICK(") == 7 and "psm_cycles_read" in src
    assert src.count("atomicMin(&w.key[j]") == 1    # the scatter's reduction
