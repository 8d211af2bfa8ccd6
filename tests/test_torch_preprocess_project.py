"""Port parity: preprocessing and the dense scan projection of
``laser_slam_tpu_torch`` against ``laser_slam_tpu``, all three presets.

Scans are ray-cast in an asymmetric room (pillar, L-block) with 1 cm
range noise, made from a seed with numpy.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on the CPU; one intra-op thread each
# keeps torch's thread pools from oversubscribing it.
torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu.ops import project as jproj
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.ops import preprocess as tpp
from laser_slam_tpu_torch.ops import project as tproj

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

PRESETS = ["LMS211", "LMS511", "LMS151"]
RANGE_ATOL = 1e-5   # float32 interpolation / transcendental round-off


def room_scans(model, poses, seed):
    """Noisy ranges ``[B, N]`` of the asymmetric test room."""
    rng = np.random.default_rng(seed)
    r = synthetic_log.ray_cast(
        synthetic_log.room_walls(), np.asarray(poses, np.float64),
        np.asarray(model.bearings(), np.float64), model.max_range,
    )
    r = np.where(r <= model.max_range, r + rng.normal(0, 0.01, r.shape), r)
    return r.astype(np.float32)


def random_poses(rng, n):
    return np.stack(
        [rng.uniform(-1.5, 3.0, n), rng.uniform(-2.0, 2.5, n), rng.uniform(-np.pi, np.pi, n)], 1
    )


@pytest.mark.parametrize("name", PRESETS)
def test_preprocess(name):
    jm = jscan.PRESETS[name]
    tm = interop.model_from_fields(dataclasses.asdict(jm))
    rng = np.random.default_rng(10)
    r = room_scans(jm, random_poses(rng, 12), seed=11)
    # A few far / short readings and a range jump exercise the masks.
    r[0, 5:9] = jm.max_range + 1.0
    r[1, 20:23] = 0.05
    r[2, 30:40] += 1.0
    js = jpp.preprocess(jnp.asarray(r), jm)
    ts = tpp.preprocess(torch.from_numpy(r), tm)
    np.testing.assert_array_equal(ts.ranges.numpy(), np.asarray(js.ranges))
    np.testing.assert_array_equal(ts.bad.numpy(), np.asarray(js.bad))
    np.testing.assert_array_equal(ts.seg.numpy(), np.asarray(js.seg))
    assert ts.seg.dtype == torch.int32 and ts.ranges.is_contiguous()
    assert ts.bad[0, 5:9].all() and ts.bad[1, 20:23].all()


@pytest.mark.parametrize("name", PRESETS)
def test_scan_project(name):
    jm = jscan.PRESETS[name]
    tm = interop.model_from_fields(dataclasses.asdict(jm))
    rng = np.random.default_rng(12)
    world = random_poses(rng, 10)
    # Scan 0 faces the L-block from the origin and is projected into a
    # frame behind the block, where its face is seen from the back.
    facing_down = -np.pi / 2 - np.radians(jm.fi_min_deg + jm.fov_deg / 2)
    world[0] = (0.0, 0.0, facing_down)
    r = room_scans(jm, world, seed=13)
    js = jpp.preprocess(jnp.asarray(r), jm)
    ts = interop.scan_from_numpy(*(np.asarray(x) for x in js))
    poses = np.concatenate(
        [rng.normal(0, 0.3, (10, 2)), rng.normal(0, 0.3, (10, 1))], 1
    ).astype(np.float32)
    poses[0] = (1.5, 3.4, facing_down)
    jp = jax.vmap(lambda s, p: jproj.scan_project(jm, s, p))(js, jnp.asarray(poses))
    tp = tproj.scan_project(tm, ts, torch.from_numpy(poses))
    np.testing.assert_array_equal(tp.empty.numpy(), np.asarray(jp.empty))
    np.testing.assert_array_equal(tp.occluded.numpy(), np.asarray(jp.occluded))
    np.testing.assert_allclose(tp.new_r.numpy(), np.asarray(jp.new_r), atol=RANGE_ATOL)
    # Some bins are empty and some occluded, so both masks are exercised.
    assert tp.empty.any() and tp.occluded.any() and (~tp.bad).sum() > 0.5 * tp.bad.numel()


def test_scan_project_unbatched_matches_batched():
    m = interop.model_from_fields(dataclasses.asdict(jscan.LMS211))
    rng = np.random.default_rng(14)
    r = room_scans(m, random_poses(rng, 3), seed=15)
    s = tpp.preprocess(torch.from_numpy(r), m)
    pose = torch.tensor([[0.1, -0.05, 0.2]] * 3)
    batched = tproj.scan_project(m, s, pose)
    single = tproj.scan_project(m, type(s)(*(x[1] for x in s)), pose[1])
    for a, b in zip(batched, single):
        np.testing.assert_array_equal(a[1].numpy(), b.numpy())


@pytest.mark.parametrize("name", PRESETS)
def test_scan_project_banded(name):
    """The banded projection against JAX's (rotations of up to ±0.6 rad:
    shifts of up to 60 bins), and against the dense one, which it equals
    where every covering pair lies inside the band."""
    jm = jscan.PRESETS[name]
    tm = interop.model_from_fields(dataclasses.asdict(jm))
    rng = np.random.default_rng(16)
    r = room_scans(jm, random_poses(rng, 10), seed=17)
    js = jpp.preprocess(jnp.asarray(r), jm)
    ts = interop.scan_from_numpy(*(np.asarray(x) for x in js))
    poses = np.concatenate([rng.normal(0, 0.2, (10, 2)), rng.uniform(-0.6, 0.6, (10, 1))],
                           1).astype(np.float32)
    jp = jax.jit(jax.vmap(lambda s, p: jproj.scan_project_banded(jm, s, p)))(js, jnp.asarray(poses))
    tp = tproj.scan_project_banded(tm, ts, torch.from_numpy(poses))
    np.testing.assert_array_equal(tp.empty.numpy(), np.asarray(jp.empty))
    np.testing.assert_array_equal(tp.occluded.numpy(), np.asarray(jp.occluded))
    np.testing.assert_allclose(tp.new_r.numpy(), np.asarray(jp.new_r), atol=RANGE_ATOL)
    dense = tproj.scan_project(tm, ts, torch.from_numpy(poses))
    same = (dense.new_r == tp.new_r).all(-1)
    assert same.sum() >= 8, same
    single = tproj.scan_project_banded(tm, type(ts)(*(x[3] for x in ts)), torch.from_numpy(poses[3]))
    for a, b in zip(tp, single):
        np.testing.assert_array_equal(a[3].numpy(), b.numpy())


def test_match_psm_banded_matches_jax():
    """``match_psm(banded=True)`` against JAX's on pairs of the test room,
    at ``tests/test_torch_psm.py``'s bounds; the fused wrapper refuses it."""
    from laser_slam_tpu.ops import psm as jpsm
    from laser_slam_tpu_torch.ops import psm as tpsm
    from laser_slam_tpu_torch.ops.cuda import psm_kernel

    jm = jscan.LMS211
    tm = interop.model_from_fields(dataclasses.asdict(jm))
    rng = np.random.default_rng(18)
    p0 = random_poses(rng, 8)
    rel = np.stack([rng.normal(0, 0.06, 8), rng.normal(0, 0.06, 8), rng.normal(0, 0.05, 8)], 1)
    from laser_slam_tpu.core import se2 as jse2

    ja = jpp.preprocess(jnp.asarray(room_scans(jm, p0, seed=19)), jm)
    jb = jpp.preprocess(jnp.asarray(room_scans(jm, jse2.np_compose(p0, rel), seed=20)), jm)
    ta, tb = (interop.scan_from_numpy(*(np.asarray(x) for x in s)) for s in (ja, jb))
    want = jax.jit(jax.vmap(lambda a, b: jpsm.match_psm(jm, a, b, banded=True)))(ja, jb)
    got = tpsm.match_psm(tm, ta, tb, banded=True)
    np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-4)
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err), rtol=1e-4)
    assert not got.fail.any() and np.median(np.abs(got.pose.numpy() - rel)) < 0.01
    with pytest.raises(ValueError, match="banded"):
        psm_kernel.match_psm_fused(tm, ta, tb, banded=True)
