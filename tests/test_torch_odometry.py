"""Port parity: keyframe and pairwise odometry of ``laser_slam_tpu_torch``
against ``laser_slam_tpu`` on a short synthetic trajectory in an
asymmetric room, with one 120° whip behind a 12× dt gap so that the
batched correlative re-match (pass 2) runs.

XLA's and PyTorch's float32 ``atan2``/``cos`` differ in the last bit on a
few percent of inputs. In a match's first projection from the zero pose,
a bin at a segment end lies within a last bit of its covering pair's
bearing, so such a difference can move one bin between empty and
covered; that pair's match then stops up to ~4 mm apart (the stop rule
accepts steps below 100·(|dx|+|dy|) + |dθ| < 0.4). On this trajectory
that happens on 15-40 % of pairs. So the drivers are compared twice:

- with JAX's PSM matcher injected into the port's driver, which holds
  the driver logic (keyframe switching, pass 2, re-chaining) to float
  round-off: poses atol 1e-3;
- end to end, where the chain accumulates the per-pair stops: flags
  identical, poses atol 2e-2.
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
from laser_slam_tpu.ops import odometry as jodo
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu.ops import psm as jpsm
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.ops import odometry as todo
from laser_slam_tpu_torch.ops import psm as tpsm
from laser_slam_tpu_torch.ops.cuda import psm_kernel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

POSE_ATOL = 1e-3          # driver alone: float32 order along the chain
END_TO_END_ATOL = 2e-2    # plus the per-pair stops described above
FLAGS = ("switched", "discarded", "weak", "fracture")
MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))


def trajectory(n=40, whip_at=20, seed=40):
    """Poses ``[n, 3]`` (5 cm / 2° steps; a 120° turn in place at
    ``whip_at``), timestamps and noisy ranges ``[n, N]``."""
    rng = np.random.default_rng(seed)
    poses = [np.asarray([-1.0, 1.0, -1.0])]
    ts = [0.0]
    for i in range(1, n):
        x, y, th = poses[-1]
        if i == whip_at:
            poses.append(np.asarray([x, y, th + np.radians(120.0)]))
            ts.append(ts[-1] + 1.2)
            continue
        th = th + np.radians(2.0) + rng.normal(0, 0.003)
        poses.append(np.asarray([x + 0.05 * np.cos(th), y + 0.05 * np.sin(th), th]))
        ts.append(ts[-1] + 0.1 + rng.normal(0, 0.002))
    poses = np.stack(poses)
    r = synthetic_log.ray_cast(synthetic_log.room_walls(), poses,
                               np.asarray(MODEL.bearings(), np.float64), MODEL.max_range)
    r = np.where(r <= MODEL.max_range, r + rng.normal(0, 0.01, r.shape), r)
    return poses, np.asarray(ts), r.astype(np.float32)


def both_scans():
    poses, ts, r = trajectory()
    js = jpp.preprocess(jnp.asarray(r), MODEL)
    return poses, ts, js, interop.scan_from_numpy(*(np.asarray(x) for x in js))


_jax_match = jax.jit(jax.vmap(lambda a, b, p: jpsm.match_psm(MODEL, a, b, p)))


def jax_psm(model, ref, cur, init_pose=None):
    """JAX's batched PSM matcher behind the port's matcher interface."""
    to_j = lambda s: jscan.Scan(*(jnp.asarray(x.numpy()) for x in s))
    init = jnp.zeros((cur.ranges.shape[0], 3)) if init_pose is None else jnp.asarray(init_pose.numpy())
    r = _jax_match(to_j(ref), to_j(cur), init)
    return tpsm.MatchResult(*(torch.from_numpy(np.array(x)) for x in r))


def check_flags(got, want):
    for f in FLAGS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)


def test_odometry_keyframe_driver_matches_jax(monkeypatch):
    gt, ts, js, tsc = both_scans()
    want = jodo.odometry_keyframe(MODEL, js, deep_chunk=2, timestamps=ts)
    monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
    got = todo.odometry_keyframe(TMODEL, tsc, deep_chunk=2, timestamps=ts)
    check_flags(got, want)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=POSE_ATOL)
    # Pass 2 ran on the whip step, over more than one chunk.
    assert got.rematched[20] and got.rematched.sum() > 2 and got.weak[20]


def test_odometry_keyframe_matches_jax():
    gt, ts, js, tsc = both_scans()
    want = jodo.odometry_keyframe(MODEL, js, deep_chunk=2, timestamps=ts)
    launches = psm_kernel.match_psm_fused.launches
    got = todo.odometry_keyframe(TMODEL, tsc, deep_chunk=2, timestamps=ts)
    assert psm_kernel.match_psm_fused.launches == launches   # CPU: plain version
    check_flags(got, want)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=END_TO_END_ATOL)
    assert got.poses.shape == (40, 3) and got.poses.dtype == torch.float32


@pytest.mark.parametrize("inject", [True, False])
def test_odometry_pairwise_matches_jax(inject, monkeypatch):
    gt, ts, js, tsc = both_scans()
    want = jodo.odometry_pairwise(MODEL, js)
    if inject:
        monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
    got = todo.odometry_pairwise(TMODEL, tsc)
    check_flags(got, want)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses),
                               atol=POSE_ATOL if inject else END_TO_END_ATOL)
    assert got.switched[1:].all() and not got.switched[0]
