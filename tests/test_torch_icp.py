"""Port parity: polar ICP (``ops/icp.match_icp``), PL-ICP
(``ops/plicp.match_plicp``) and ``odometry_pairwise(use_icp=True)`` of
``laser_slam_tpu_torch`` against ``laser_slam_tpu`` on the same numpy
inputs: box-room pairs (``tests/conftest.py``) at random poses and
motions, and consecutive pairs of the synthetic floor plan.

The iteration counts are held too: JAX's are read by running its matcher
with the iteration cap as a traced argument (one compile) and taking,
per pair, the first cap at which the result stops changing.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.core import se2 as jse2
from laser_slam_tpu.ops import icp as jicp
from laser_slam_tpu.ops import odometry as jodo
from laser_slam_tpu.ops import plicp as jplicp
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.ops import icp as ticp
from laser_slam_tpu_torch.ops import odometry as todo
from laser_slam_tpu_torch.ops import plicp as tplicp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
POSE_ATOL = 1e-5      # [m, rad] one match, float32 op order
ERR_ATOL = 1e-5       # [m] mean residual
COV_RTOL = 1e-4       # PL-ICP covariance, relative to its largest entry
CHAIN_ATOL = 2e-2     # [m, rad] a chained pairwise trajectory (see the test)


@pytest.fixture(scope="module")
def box_pairs():
    """24 box-room pairs: a random pose in the room, a random motion of up
    to 30 cm and 0.25 rad, 4 mm range noise; and two pairs that fail (the
    second scan blank). Preprocessed by JAX, as numpy."""
    from conftest import box_room_ranges

    rng = np.random.default_rng(0)
    a, b = [], []
    for _ in range(24):
        pa = np.array([rng.uniform(-1.5, 2.5), rng.uniform(-2, 2), rng.uniform(-np.pi, np.pi)])
        rel = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), rng.uniform(-0.25, 0.25)])
        a.append(box_room_ranges(MODEL, pa) + rng.normal(0, 0.004, MODEL.n_beams))
        b.append(box_room_ranges(MODEL, jse2.np_compose(pa, rel)) + rng.normal(0, 0.004, MODEL.n_beams))
    b[5][:] = b[17][:] = MODEL.max_range + 1.0
    ja = jpp.preprocess(jnp.asarray(np.float32(a)), MODEL)
    jb = jpp.preprocess(jnp.asarray(np.float32(b)), MODEL)
    return tuple(np.asarray(x) for x in ja), tuple(np.asarray(x) for x in jb)


def scans(pairs):
    return ([jscan.Scan(*(jnp.asarray(x) for x in s)) for s in pairs],
            [interop.scan_from_numpy(*s) for s in pairs])


def jax_iterations(module, cap_name, match, ref, cur):
    """Per pair, the number of iterations JAX's ``match`` ran: the first
    cap ``k`` whose pose equals the pose at the module's own cap (the
    same program throughout)."""
    cap = getattr(module, cap_name)

    def capped(a, b, k):
        setattr(module, cap_name, k)       # read while tracing: a traced cap
        try:
            return jax.vmap(lambda x, y: match(MODEL, x, y))(a, b).pose
        finally:
            setattr(module, cap_name, cap)

    run = jax.jit(capped)
    poses = np.stack([np.asarray(run(ref, cur, k)) for k in range(cap + 1)])
    return np.argmax(np.all(poses == poses[-1:], axis=-1), axis=0)


def test_match_icp_matches_jax(box_pairs):
    (ja, jb), (ta, tb) = scans(box_pairs)
    want = jax.jit(jax.vmap(lambda a, b: jicp.match_icp(MODEL, a, b)))(ja, jb)
    info = {}
    got = ticp.match_icp(TMODEL, ta, tb, info=info)
    np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))
    assert got.fail.numpy().tolist().count(True) == 2 and got.fail[5] and got.fail[17]
    ok = ~got.fail.numpy()
    np.testing.assert_allclose(got.pose.numpy()[ok], np.asarray(want.pose)[ok], atol=POSE_ATOL)
    np.testing.assert_allclose(got.err.numpy()[ok], np.asarray(want.err)[ok], atol=ERR_ATOL)
    np.testing.assert_array_equal(got.n_valid.numpy(), np.asarray(want.n_valid))
    iters = jax_iterations(jicp, "MAX_ITER_ICP", jicp.match_icp, ja, jb)
    np.testing.assert_array_equal(info["iters"].numpy()[ok], iters[ok])
    assert info["iters"].numpy()[ok].min() >= 3 and info["iters"].numpy().max() < ticp.MAX_ITER_ICP


def test_match_icp_from_a_prior_and_one_pair(box_pairs):
    """A nonzero initial pose; and a pair alone comes out as it does in
    the batch (the early exit reads the batch's flags, a frozen pair
    keeps its state)."""
    (ja, jb), (ta, tb) = scans(box_pairs)
    init = np.float32(np.random.default_rng(1).normal(0, [0.05, 0.05, 0.03], (24, 3)))
    want = jax.jit(jax.vmap(lambda a, b, p: jicp.match_icp(MODEL, a, b, p)))(ja, jb, jnp.asarray(init))
    got = ticp.match_icp(TMODEL, ta, tb, torch.from_numpy(init))
    ok = ~np.asarray(want.fail)
    np.testing.assert_allclose(got.pose.numpy()[ok], np.asarray(want.pose)[ok], atol=POSE_ATOL)
    batch = ticp.match_icp(TMODEL, ta, tb)
    for k in (3, 10):
        one = ticp.match_icp(TMODEL, *(type(s)(*(x[k:k + 1] for x in s)) for s in (ta, tb)))
        np.testing.assert_allclose(one.pose.numpy()[0], batch.pose.numpy()[k], atol=POSE_ATOL)


def test_match_plicp_matches_jax(box_pairs):
    (ja, jb), (ta, tb) = scans(box_pairs)
    want = jax.jit(jax.vmap(lambda a, b: jplicp.match_plicp(MODEL, a, b)))(ja, jb)
    info = {}
    got = tplicp.match_plicp(TMODEL, ta, tb, info=info)
    assert set(got._fields) == set(want._fields)
    np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))
    ok = ~got.fail.numpy()
    assert ok.sum() == 22
    np.testing.assert_allclose(got.pose.numpy()[ok], np.asarray(want.pose)[ok], atol=POSE_ATOL)
    np.testing.assert_allclose(got.err.numpy()[ok], np.asarray(want.err)[ok], rtol=1e-3, atol=1e-9)
    np.testing.assert_array_equal(got.n_valid.numpy(), np.asarray(want.n_valid))
    cov_w = np.asarray(want.cov)[ok]
    scale = np.abs(cov_w).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got.cov.numpy()[ok] / scale, cov_w / scale, atol=COV_RTOL)
    iters = jax_iterations(jplicp, "MAX_ITERATIONS", jplicp.match_plicp, ja, jb)
    np.testing.assert_array_equal(info["iters"].numpy()[ok], iters[ok])
    # The result crosses through interop as JAX's namesake's fields.
    back = interop.named_state_to_numpy(got)
    assert back.keys() == want._asdict().keys() and back["cov"].shape == (24, 3, 3)
    again = interop.named_state_from_numpy(tplicp.PlIcpResult, back)
    assert torch.equal(again.fail, got.fail) and again.n_valid.dtype == torch.int32


def test_odometry_pairwise_with_icp_matches_jax():
    """Pairwise polar-ICP odometry over 80 scans of the synthetic floor
    plan. Per pair the two packages agree to float round-off where the
    first projection covers the same bins; the last bit of ``atan2`` /
    ``cos`` (XLA against ATen) can flip a bin at a segment end, which
    moves a match by up to a few mm, and the chain carries it on: the
    relatives are held at 1e-3 on 95 % of the pairs, the chained poses at
    2e-2."""
    ranges, _, _ = synthetic_log.synthetic_log(n_scans=80, n_whips=0)
    ranges = np.concatenate([ranges, np.full((80, 1), MODEL.max_range + 1.0, np.float32)], 1)
    js = jpp.preprocess(jnp.asarray(ranges), MODEL)
    want = jodo.odometry_pairwise(MODEL, js, use_icp=True)
    got = todo.odometry_pairwise(TMODEL, interop.scan_from_numpy(*(np.asarray(x) for x in js)),
                                 use_icp=True)
    for f in ("switched", "discarded", "weak", "fracture"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    gp, wp = got.poses.numpy(), np.asarray(want.poses)
    rel_g = jse2.np_relative(gp[:-1], gp[1:])
    rel_w = jse2.np_relative(wp[:-1], wp[1:])
    close = np.abs(rel_g - rel_w).max(axis=1) <= 1e-3
    assert close.mean() >= 0.95, close.mean()
    np.testing.assert_allclose(gp, wp, atol=CHAIN_ATOL)
    assert np.linalg.norm(gp[-1, :2] - gp[0, :2]) > 0.5     # the robot moved
