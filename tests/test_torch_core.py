"""Port parity: SE(2) algebra (with the exponential and logarithm maps),
laser models, ``Scan.points``, ``preprocess_log`` and the CARMEN reader of
``laser_slam_tpu_torch`` against ``laser_slam_tpu`` on the same inputs."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on the CPU; one intra-op thread each
# keeps torch's thread pools from oversubscribing it.
torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.core import se2 as jse2
from laser_slam_tpu.io.carmen import read_carmen as jread
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.core import scan as tscan
from laser_slam_tpu_torch.core import se2 as tse2
from laser_slam_tpu_torch.io.carmen import read_carmen as tread

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

SE2_ATOL = 1e-5    # float32 op order
CHAIN_ATOL = 1e-4  # doubling scan vs associative_scan composition order


def _poses(rng, n):
    return np.stack(
        [rng.normal(0, 3, n), rng.normal(0, 3, n), rng.uniform(-np.pi, np.pi, n)], 1
    ).astype(np.float32)


@pytest.mark.parametrize("op", ["compose", "relative"])
def test_se2_binary_ops(op):
    rng = np.random.default_rng(0)
    a, b = _poses(rng, 64), _poses(rng, 64)
    want = np.asarray(getattr(jse2, op)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tse2, op)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=SE2_ATOL)


@pytest.mark.parametrize("op", ["inverse", "normalize_angle", "rotation_matrix"])
def test_se2_unary_ops(op):
    rng = np.random.default_rng(1)
    x = _poses(rng, 64)
    if op != "inverse":
        x = (x[:, 2] * 5.0).astype(np.float32)   # angles well outside [-π, π)
    want = np.asarray(getattr(jse2, op)(jnp.asarray(x)))
    got = getattr(tse2, op)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=SE2_ATOL)


def test_identity_matches_jax():
    for shape in [(), (4,), (2, 3)]:
        got, want = tse2.identity(shape), jse2.identity(shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert not got.any()
    a = torch.tensor([1.0, 2.0, 0.5])
    np.testing.assert_allclose(tse2.compose(a, tse2.identity()).numpy(), a.numpy(), atol=1e-6)
    np.testing.assert_allclose(tse2.compose(tse2.identity(), a).numpy(), a.numpy(), atol=1e-6)


def test_exp_log_roundtrip_matches_jax():
    """``tests/test_se2.py``'s round trip, and both maps against JAX: twists
    of all sizes, the |ω| < 1e-6 Taylor branch (ω = 0, ±1e-7, ±9e-7)
    and angles beyond ±π."""
    rng = np.random.default_rng(2)
    tw = (rng.normal(size=(32, 3)) * 0.5).astype(np.float32)
    tw[:5, 2] = [0.0, 1e-7, -1e-7, 9e-7, -9e-7]
    back = tse2.log(tse2.exp(torch.from_numpy(tw))).numpy()
    assert np.allclose(back, tw, atol=1e-4)
    np.testing.assert_allclose(tse2.exp(torch.from_numpy(tw)).numpy(),
                               np.asarray(jse2.exp(jnp.asarray(tw))), atol=SE2_ATOL)
    poses = _poses(rng, 64)
    poses[:3, 2] = [0.0, 5e-7, 7.5]
    np.testing.assert_allclose(tse2.log(torch.from_numpy(poses)).numpy(),
                               np.asarray(jse2.log(jnp.asarray(poses))), atol=SE2_ATOL, rtol=1e-5)


def test_exp_zero_rotation():
    t = torch.tensor([1.0, -2.0, 0.0])
    assert np.allclose(tse2.exp(t).numpy(), t.numpy(), atol=1e-6)
    np.testing.assert_array_equal(tse2.exp(t).numpy(), np.asarray(jse2.exp(jnp.asarray(t.numpy()))))


@pytest.mark.parametrize("name", ["LMS211", "LMS151"])
def test_scan_points_and_preprocess_log(name):
    jm = jscan.PRESETS[name]
    tm = interop.model_from_fields(dataclasses.asdict(jm))
    rng = np.random.default_rng(4)
    r = rng.uniform(0.05, 60.0, (5, jm.n_beams)).astype(np.float32)
    from laser_slam_tpu.ops.preprocess import preprocess_log as jlog
    from laser_slam_tpu_torch.ops.preprocess import preprocess_log as tlog

    js_, ts_ = jlog(jnp.asarray(r), jm), tlog(torch.from_numpy(r), tm)
    for a, b in zip(ts_, js_):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(ts_.points(tm).numpy(), np.asarray(js_.points(jm)), atol=SE2_ATOL)
    assert tscan.Scan(*(x[0] for x in ts_)).points(tm).shape == (jm.n_beams, 2)


def test_transform_points():
    rng = np.random.default_rng(2)
    pose = _poses(rng, 4)
    pts = rng.normal(0, 5, (4, 30, 2)).astype(np.float32)
    want = np.asarray(jse2.transform_points(jnp.asarray(pose), jnp.asarray(pts)))
    got = tse2.transform_points(torch.from_numpy(pose), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=SE2_ATOL)


def test_chain_200_steps():
    rng = np.random.default_rng(3)
    rel = np.stack(
        [rng.normal(0.05, 0.02, 200), rng.normal(0, 0.02, 200), rng.normal(0, 0.05, 200)], 1
    ).astype(np.float32)
    init = np.asarray([1.0, -2.0, 0.3], np.float32)
    want = np.asarray(jse2.chain(jnp.asarray(rel), jnp.asarray(init)))
    got = tse2.chain(torch.from_numpy(rel), torch.from_numpy(init)).numpy()
    np.testing.assert_allclose(got, want, atol=CHAIN_ATOL)
    # The sequential definition, in float64.
    seq = [np.float64(init)]
    for r in rel.astype(np.float64):
        seq.append(tse2.np_compose(seq[-1], r))
    np.testing.assert_allclose(got, np.stack(seq[1:]), atol=CHAIN_ATOL)


@pytest.mark.parametrize("name", ["np_compose", "np_relative", "np_inverse", "np_normalize_angle"])
def test_numpy_twins(name):
    rng = np.random.default_rng(4)
    a, b = _poses(rng, 16).astype(np.float64), _poses(rng, 16).astype(np.float64)
    args = (a,) if name == "np_inverse" else (a[:, 2] * 5,) if name == "np_normalize_angle" else (a, b)
    np.testing.assert_array_equal(getattr(tse2, name)(*args), getattr(jse2, name)(*args))


@pytest.mark.parametrize("name", ["LMS211", "LMS511", "LMS151"])
def test_laser_model_fields_and_bearings(name):
    jm = jscan.PRESETS[name]
    tm = interop.model_from_fields(dataclasses.asdict(jm))
    assert tm == tscan.PRESETS[name]
    assert interop.model_to_fields(tm) == dataclasses.asdict(jm)
    assert (tm.fi_min, tm.dfi) == (jm.fi_min, jm.dfi)
    np.testing.assert_allclose(tm.bearings().numpy(), np.asarray(jm.bearings()), atol=1e-7)
    header = jm.with_start(-1.5, 30.0)
    assert interop.model_to_fields(tm.with_start(-1.5, 30.0)) == dataclasses.asdict(header)


def test_raw_scan_and_pad_beams():
    m = tscan.LMS211
    r = np.linspace(0.0, 60.0, m.n_beams).astype(np.float32)
    js = jscan.raw_scan(jnp.asarray(r), jscan.LMS211)
    ts = tscan.raw_scan(torch.from_numpy(r), m)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # The scan crosses back to numpy unchanged.
    for a, b in zip(js, interop.scan_to_numpy(interop.scan_from_numpy(*js))):
        np.testing.assert_array_equal(np.asarray(a), b)
    x = np.ones((3, 180), np.float32)
    np.testing.assert_array_equal(tscan.pad_beams(x, 181, 51.0), jscan.pad_beams(x, 181, 51.0))
    np.testing.assert_array_equal(tscan.pad_beams(x, 90, 51.0), jscan.pad_beams(x, 90, 51.0))


def test_carmen_round_trip(tmp_path):
    """The generator's CARMEN file reads identically through both readers
    and gives back what was written."""
    ranges, poses, ts = synthetic_log.synthetic_log(n_scans=40, seed=5, n_whips=1)
    path = str(tmp_path / "synthetic.log")
    synthetic_log.write_carmen(path, ranges, poses, ts)
    j, t = jread(path), tread(path)
    for f in ("ranges", "laser_pose", "gt_pose", "timestamps"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    assert dataclasses.asdict(t.model) == dataclasses.asdict(j.model)
    assert t.model.n_beams == 181 and t.ranges.shape == (40, 181)
    np.testing.assert_allclose(t.ranges[:, :180], ranges, atol=5e-5)
    assert np.all(t.ranges[:, 180] == t.model.max_range + 1.0)
    np.testing.assert_allclose(t.gt_pose, poses, atol=2e-6)
    np.testing.assert_allclose(t.timestamps, ts, atol=1e-6)
    assert np.diff(ts).max() == pytest.approx(12 * synthetic_log.DT)
    # max_scans stops early, as in the reference reader.
    assert tread(path, max_scans=7).ranges.shape == (7, 181)
