"""Port parity: ``laser_slam_tpu_torch.fusion.ukf`` against
``laser_slam_tpu.fusion.ukf`` on the same inputs, made from a seed with
numpy. Both run in float32 on the CPU. The 3×3 inverse is an LU solve in
XLA and LAPACK's ``getri`` in torch, and the two packages' ``cos``/``sin``
differ in the last bit, so states are held to 1e-5 (absolute, on values
of order 1), also along a 50-tick sequence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.fusion import ukf as jukf
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.fusion import ukf as tukf

ATOL = 1e-5


def make_states(seed=3):
    rng = np.random.default_rng(seed)
    mean = rng.normal(0, 1, 3).astype(np.float32)
    a = rng.normal(0, 0.3, (3, 3)).astype(np.float32)
    cov = (a @ a.T + 0.05 * np.eye(3)).astype(np.float32)
    return (jukf.UkfState(jnp.asarray(mean), jnp.asarray(cov)),
            interop.named_state_from_numpy(tukf.UkfState, {"mean": mean, "cov": cov}), rng)


def check(t_state, j_state, atol=ATOL):
    got = interop.named_state_to_numpy(t_state)
    np.testing.assert_allclose(got["mean"], np.asarray(j_state.mean), atol=atol)
    np.testing.assert_allclose(got["cov"], np.asarray(j_state.cov), atol=atol)


def test_init_matches_jax():
    check(tukf.init(torch.tensor([1.0, -2.0, 0.5]), 0.01, device="cpu"),
          jukf.init(jnp.asarray([1.0, -2.0, 0.5]), 0.01), atol=0)
    cov = np.diag([0.1, 0.2, 0.3]).astype(np.float32)
    check(tukf.init(torch.zeros(3), torch.from_numpy(cov)), jukf.init(jnp.zeros(3), jnp.asarray(cov)),
          atol=0)


@pytest.mark.parametrize("with_motion", [False, True])
def test_predict_matches_jax(with_motion):
    js, ts, rng = make_states()
    motion = rng.normal(0, 0.2, 3).astype(np.float32) if with_motion else None
    check(tukf.predict(ts, None if motion is None else torch.from_numpy(motion), 0.05),
          jukf.predict(js, None if motion is None else jnp.asarray(motion), 0.05))
    before = ts.cov.clone()
    tukf.predict(ts, q=1.0)
    assert torch.equal(ts.cov, before)          # pure: the input state is untouched


def test_updates_match_jax():
    js, ts, rng = make_states(5)
    # The angle innovation wraps: observe a heading near -pi from a mean near +pi.
    js = js._replace(mean=js.mean.at[2].set(3.1))
    ts = ts._replace(mean=torch.cat([ts.mean[:2], torch.tensor([3.1])]))
    z = np.asarray([0.4, -0.3, -3.1], np.float32)
    jp, tp = jukf.update_pose(js, jnp.asarray(z), 0.02), tukf.update_pose(ts, torch.from_numpy(z), 0.02)
    check(tp, jp)
    assert abs(float(tp.mean[2])) > 3.0          # went the short way round
    r = np.diag([0.1, 0.3]).astype(np.float32)
    for idx, zz, rr in (((0, 1), z[:2], 0.25), ((2, 0), z[[2, 0]], r)):
        check(tukf.update_partial(ts, idx, torch.from_numpy(zz),
                                  torch.from_numpy(rr) if isinstance(rr, np.ndarray) else rr),
              jukf.update_partial(js, idx, jnp.asarray(zz),
                                  jnp.asarray(rr) if isinstance(rr, np.ndarray) else rr))


def test_sigma_points_and_nonlinear_update_match_jax():
    js, ts, rng = make_states(9)
    for a, b in zip(tukf._sigma_points(ts), jukf._sigma_points(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    beacon = np.asarray([2.0, -1.0], np.float32)
    # The GPS range model: distance to a beacon. JAX maps it over the sigma
    # points with vmap; the port hands it the points as one batch.
    jh = lambda x: jnp.linalg.norm(x[:2] - jnp.asarray(beacon))
    th = lambda x: torch.sqrt(torch.sum((x[:, :2] - torch.from_numpy(beacon)) ** 2, dim=-1))
    check(tukf.update_nonlinear(ts, th, torch.tensor(2.4), 0.1),
          jukf.update_nonlinear(js, jh, jnp.asarray(2.4), 0.1))
    # A two-component observation with a matrix R.
    jh2 = lambda x: jnp.stack([x[0] * jnp.cos(x[2]), x[1] + x[0] ** 2])
    th2 = lambda x: torch.stack([x[:, 0] * torch.cos(x[:, 2]), x[:, 1] + x[:, 0] ** 2], dim=-1)
    z2 = np.asarray([0.3, 0.8], np.float32)
    r2 = np.diag([0.05, 0.2]).astype(np.float32)
    check(tukf.update_nonlinear(ts, th2, torch.from_numpy(z2), torch.from_numpy(r2)),
          jukf.update_nonlinear(js, jh2, jnp.asarray(z2), jnp.asarray(r2)))


def test_fusion_step_sequence_matches_jax():
    """50 ticks: odometry now and then invalid, SLAM poses with stale and
    out-of-order stamps, beacon fixes rare, some unstamped (+inf: always
    fresh). The state and the filter time are held at every tick."""
    rng = np.random.default_rng(11)
    js = jukf.init(jnp.zeros(3), 0.01)
    ts = tukf.init(torch.zeros(3), 0.01)
    jt, tt = -jnp.inf, -float("inf")
    truth = np.zeros(3, np.float32)
    skipped = 0
    for k in range(50):
        rel = np.asarray([0.1, 0.01 * np.sin(k), 0.03], np.float32)
        truth = truth + rel
        slam = (truth + rng.normal(0, 0.02, 3)).astype(np.float32)
        beacon = (truth[:2] + rng.normal(0, 0.3, 2)).astype(np.float32)
        odom_ok, beacon_ok = bool(k % 7), k % 5 == 0
        # Stamps: mostly k, every fourth tick an old one (k - 3, stale or
        # out of order), every ninth none at all.
        slam_t = np.inf if k % 9 == 8 else float(k - 3 if k % 4 == 3 else k)
        beacon_t = np.inf if k % 10 == 0 else float(k) - 0.5
        ji = jukf.FusionInputs(jnp.asarray(rel), jnp.asarray(odom_ok), jnp.asarray(slam),
                               jnp.asarray(True), jnp.asarray(beacon), jnp.asarray(beacon_ok),
                               slam_t=jnp.asarray(slam_t, jnp.float32),
                               beacon_t=jnp.asarray(beacon_t, jnp.float32))
        ti = tukf.FusionInputs(torch.from_numpy(rel), torch.tensor(odom_ok), torch.from_numpy(slam),
                               torch.tensor(True), torch.from_numpy(beacon), torch.tensor(beacon_ok),
                               slam_t=slam_t, beacon_t=torch.tensor(beacon_t))
        skipped += int(slam_t <= float(tt))     # stale: the filter is past this stamp
        js, jt = jukf.fusion_step(js, ji, filter_t=jt)
        ts, tt = tukf.fusion_step(ts, ti, filter_t=tt)
        check(ts, js)
        assert float(tt) == float(jt)
    assert skipped >= 5 and np.isfinite(float(tt))
    # The default stamps (all +inf) leave the filter time where it was.
    ti = tukf.FusionInputs(torch.zeros(3), torch.tensor(True), torch.zeros(3), torch.tensor(True),
                           torch.zeros(2), torch.tensor(False))
    assert float(tukf.fusion_step(ts, ti, filter_t=tt)[1]) == float(tt)
