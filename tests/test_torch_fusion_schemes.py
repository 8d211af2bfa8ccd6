"""Port parity: the covariance and UdU filters (``fusion/kalman``) and the
landmark-SLAM schemes (``fusion/slam_schemes``) of ``laser_slam_tpu_torch``
against ``laser_slam_tpu`` on the same numpy inputs, made from a seed; and
the behaviour tests of ``tests/test_fusion_schemes.py`` on the port.

Both packages run float32 on the CPU. Their matrix products and small
solves sum in other orders (XLA's dot and LU against ATen's), so a state
is held to 1e-5 per step on values of order 1 (``ATOL``), and a
covariance that holds 1e6 for unseen landmarks to 1e-5 relative as well
(``RTOL``). fastSLAM's random draws are JAX's, fed to the port's
deterministic halves (``fastslam_predict_with_noise``,
``fastslam_resample_at``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.core import se2 as jse2
from laser_slam_tpu.fusion import kalman as jk
from laser_slam_tpu.fusion import slam_schemes as js
from laser_slam_tpu_torch import fusion as tfusion
from laser_slam_tpu_torch.fusion import kalman as tk
from laser_slam_tpu_torch.fusion import slam_schemes as ts

ATOL = 1e-5
RTOL = 1e-5
# EKF-SLAM run for 50 steps in each package on its own: float32 round-off
# of the two packages' products carried along 50 predicts and 150 joint
# updates.
RUN_ATOL = 1e-4


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def spd(rng, n, shift=1.0):
    a = rng.normal(size=(n, n)).astype(np.float32)
    return (a @ a.T + shift * np.eye(n, dtype=np.float32)).astype(np.float32)


def motion(lib, x):
    """A unicycle step (jnp or torch)."""
    return lib.stack([x[0] + 0.1 * lib.cos(x[2]), x[1] + 0.1 * lib.sin(x[2]), x[2] + 0.05])


def range_bearing(lib, x, b):
    d0, d1 = b[0] - x[0], b[1] - x[1]
    return lib.stack([lib.sqrt(d0 * d0 + d1 * d1), lib.arctan2(d1, d0) - x[2]])


def test_fusion_exports_match_jax():
    from laser_slam_tpu import fusion as jfusion

    assert tfusion.__all__ == jfusion.__all__


# -- covariance (EKF) filter -------------------------------------------------


def test_kalman_linear_converges():
    s = tk.init(torch.zeros(3), 4.0)
    z = torch.tensor([1.0, -2.0, 0.5])
    F = torch.eye(3)
    for _ in range(8):
        s = tk.predict_linear(s, F, 0.01)
        s = tk.update_linear(s, torch.eye(3), z - s.mean, 0.01)
    assert np.allclose(s.mean.numpy(), z.numpy(), atol=0.05)
    assert np.all(np.diag(s.cov.numpy()) < 0.1)
    close(tk.init(torch.zeros(3), 4.0).cov, jk.init(jnp.zeros(3), 4.0).cov, atol=0)


def test_kalman_nonlinear_range_observe():
    # observe distance to origin; state should shrink toward the circle
    s = tk.init(torch.tensor([2.0, 0.0]), 1.0)
    j = jk.init(jnp.asarray([2.0, 0.0]), 1.0)
    for _ in range(10):
        s = tk.update(s, torch.linalg.norm, torch.tensor(1.0), 0.001)
        j = jk.update(j, jnp.linalg.norm, jnp.asarray(1.0), 0.001)
        close(s.mean, j.mean)
        close(s.cov, j.cov)
    assert abs(float(torch.linalg.norm(s.mean)) - 1.0) < 0.02


def test_kalman_matches_jax_step_by_step():
    """A range-bearing covariance filter: the nonlinear predict and observe
    (linearized by ``jacfwd``) and the linear forms, each step started
    from JAX's state in both packages."""
    rng = np.random.default_rng(5)
    beacon = np.asarray([3.0, -1.0], np.float32)
    state = jk.KalmanState(jnp.asarray(rng.normal(size=3).astype(np.float32)),
                           jnp.asarray(spd(rng, 3, 0.5) * 0.1))
    for _ in range(20):
        z = (np.asarray(range_bearing(np, np.asarray(state.mean), beacon), np.float32)
             + np.float32(rng.normal(size=2) * 0.01))
        jp = jk.predict(state, lambda x: motion(jnp, x), 1e-3)
        tp = tk.predict(tk.KalmanState(t(state.mean), t(state.cov)), lambda x: motion(torch, x), 1e-3)
        close(tp.mean, jp.mean)
        close(tp.cov, jp.cov)
        ju = jk.update(jp, lambda x: range_bearing(jnp, x, jnp.asarray(beacon)), jnp.asarray(z), 1e-2)
        tu = tk.update(tk.KalmanState(t(jp.mean), t(jp.cov)),
                       lambda x: range_bearing(torch, x, t(beacon)), t(z), 1e-2)
        close(tu.mean, ju.mean)
        close(tu.cov, ju.cov)
        F = np.eye(3, dtype=np.float32) + np.float32(rng.normal(size=(3, 3)) * 0.05)
        H = np.float32(rng.normal(size=(2, 3)))
        q = np.diag(np.float32([1e-3, 2e-3, 5e-4]))
        jl = jk.update_linear(jk.predict_linear(ju, jnp.asarray(F), jnp.asarray(q)),
                              jnp.asarray(H), jnp.asarray(z), 0.05)
        tl = tk.update_linear(tk.predict_linear(tk.KalmanState(t(ju.mean), t(ju.cov)), t(F), t(q)),
                              t(H), t(z), 0.05)
        close(tl.mean, jl.mean)
        close(tl.cov, jl.cov)
        state = jl


# -- UdU factorized filter ----------------------------------------------------


def test_udu_factorize_roundtrip():
    rng = np.random.default_rng(0)
    P = spd(rng, 5, 0.5)
    U, d = tk.udu_factorize(t(P))
    U, d = U.numpy(), d.numpy()
    # U unit upper-triangular
    assert np.allclose(np.diag(U), 1.0)
    assert np.allclose(np.tril(U, -1), 0.0, atol=1e-6)
    assert np.all(d > 0)
    assert np.allclose(U @ np.diag(d) @ U.T, P, atol=1e-3)
    jU, jd = jk.udu_factorize(jnp.asarray(P))
    close(U, jU)
    close(d, jd)
    # A singular block: a zero pivot leaves its column's multipliers zero.
    P[4, :] = P[:, 4] = 0.0
    close(tk.udu_factorize(t(P))[0], jk.udu_factorize(jnp.asarray(P))[0])


def test_bierman_matches_joseph_update():
    """One scalar observe via Bierman factors == covariance filter, and
    == JAX's Bierman update."""
    rng = np.random.default_rng(1)
    P = spd(rng, 4)
    mean = rng.normal(size=4).astype(np.float32)
    h = rng.normal(size=4).astype(np.float32)
    innov, r = np.float32(0.7), 0.3

    ks = tk.update_linear(tk.KalmanState(t(mean), t(P)), t(h)[None, :], t(innov)[None], r)
    us = tk.bierman_update(tk.ud_init(t(mean), t(P)), t(h), t(innov), r)
    assert np.allclose(us.mean.numpy(), ks.mean.numpy(), atol=1e-3)
    assert np.allclose(us.cov().numpy(), ks.cov.numpy(), atol=1e-2)

    ju = jk.bierman_update(jk.ud_init(jnp.asarray(mean), jnp.asarray(P)), jnp.asarray(h),
                           jnp.asarray(innov), r)
    for a, b in zip(us, ju):
        close(a, b)


def test_thornton_matches_covariance_predict():
    rng = np.random.default_rng(2)
    P = spd(rng, 3)
    F = np.eye(3, dtype=np.float32) + 0.1 * rng.normal(size=(3, 3)).astype(np.float32)
    q = np.asarray([0.2, 0.1, 0.05], np.float32)
    mean = np.asarray([1.0, 2.0, 3.0], np.float32)

    ks = tk.predict_linear(tk.KalmanState(t(mean), t(P)), t(F), torch.diag(t(q)))
    us = tk.thornton_predict(tk.UdState(t(mean), *tk.udu_factorize(t(P))), t(F), t(q))
    assert np.allclose(us.mean.numpy(), ks.mean.numpy(), atol=1e-5)
    assert np.allclose(us.cov().numpy(), ks.cov.numpy(), atol=1e-3)

    ju = jk.thornton_predict(jk.UdState(jnp.asarray(mean), *jk.udu_factorize(jnp.asarray(P))),
                             jnp.asarray(F), jnp.asarray(q))
    for a, b in zip(us, ju):
        close(a, b)


def test_ud_filter_runs_and_matches_jax():
    """The square-root filter's predict/update loop converges, step for
    step with JAX's, and agrees with the covariance filter (state 6)."""
    rng = np.random.default_rng(4)
    us = tk.ud_init(torch.zeros(3), 2.0)
    ju = jk.ud_init(jnp.zeros(3), 2.0)
    target = np.asarray([1.0, -1.0, 0.5], np.float32)
    for _ in range(10):
        us = tk.thornton_predict(us, torch.eye(3), torch.full((3,), 0.01))
        us = tk.ud_update(us, torch.eye(3), t(target) - us.mean, torch.full((3,), 0.1))
        ju = jk.thornton_predict(ju, jnp.eye(3), jnp.full(3, 0.01))
        ju = jk.ud_update(ju, jnp.eye(3), jnp.asarray(target) - ju.mean, jnp.full(3, 0.1))
        for a, b in zip(us, ju):
            close(a, b)
    assert np.allclose(us.mean.numpy(), target, atol=0.05)

    n = 6
    P = spd(rng, n) * 0.1
    us = tk.ud_init(torch.zeros(n), t(P))
    ks = tk.init(torch.zeros(n), t(P))
    for _ in range(15):
        F = np.eye(n, dtype=np.float32) + np.float32(rng.normal(size=(n, n)) * 0.03)
        q = np.float32(rng.uniform(1e-3, 1e-2, n))
        H = np.float32(rng.normal(size=(2, n)))
        z = np.float32(rng.normal(size=2))
        us = tk.thornton_predict(us, t(F), t(q))
        ks = tk.predict_linear(ks, t(F), torch.diag(t(q)))
        r = np.float32([0.05, 0.2])
        us = tk.ud_update(us, t(H), t(z) - t(H) @ us.mean, t(r))
        ks = tk.update_linear(ks, t(H), t(z) - t(H) @ ks.mean, torch.diag(t(r)))
        close(us.mean, ks.mean, atol=1e-4, rtol=0)
        close(us.cov(), ks.cov, atol=1e-4, rtol=1e-4)


# -- EKF-SLAM ------------------------------------------------------------------


def _obs(pose, lm, rng=None, noise=0.0):
    d = np.asarray(lm) - np.asarray(pose[:2])
    z = np.asarray([np.hypot(*d), np.arctan2(d[1], d[0]) - pose[2]], np.float32)
    if noise:
        z = z + rng.normal(0, noise, 2).astype(np.float32)
    return z


def test_ekfslam_localizes_landmarks_like_jax():
    """``tests/test_fusion_schemes.py``'s EKF-SLAM run (3 landmarks of 4
    slots, 30 steps) and 20 more, both packages on the same observations."""
    lms = np.asarray([[2.0, 1.0], [-1.0, 2.0], [0.5, -2.0]], np.float32)
    s = ts.ekfslam_init(torch.zeros(3), max_landmarks=4, device="cpu")
    j = js.ekfslam_init(jnp.zeros(3), max_landmarks=4)
    close(s.cov, j.cov, atol=0, rtol=0)
    rng = np.random.default_rng(0)
    pose = np.zeros(3, np.float32)
    step = jax.jit(js.ekfslam_observe)
    for k in range(50):
        m = np.asarray([0.05, 0.0, 0.05], np.float32)
        s = ts.ekfslam_predict(s, t(m), 1e-4)
        j = js.ekfslam_predict(j, jnp.asarray(m), 1e-4)
        pose = np.asarray(jse2.compose(jnp.asarray(pose), jnp.asarray(m)))
        for lm in range(3):
            z = _obs(pose, lms[lm], rng, 0.005)
            s = ts.ekfslam_observe(s, torch.tensor(lm), t(z), 1e-4)
            j = step(j, lm, jnp.asarray(z), 1e-4)
        close(s.mean, j.mean, atol=RUN_ATOL, rtol=0)
        close(s.cov, j.cov, atol=RUN_ATOL, rtol=RTOL)
        np.testing.assert_array_equal(s.lm_valid.numpy(), np.asarray(j.lm_valid))
        if k == 29:
            est = s.landmarks().numpy()[:3]
            assert np.allclose(est, lms, atol=0.1), est
            assert np.allclose(s.robot().numpy(), pose, atol=0.1)
            assert bool(np.all(s.lm_valid.numpy()[:3]))


@pytest.mark.parametrize("lm_id", [0, 3, 4, 9, -1, -4, -6])
def test_ekfslam_observe_at_any_landmark_index_matches_jax(lm_id):
    """One observe from a state with landmarks 0-2 seen, at the last slot
    (``L - 1``) and beyond it both ways: XLA clamps a slice start so that
    the slice fits (a negative one counting from the end first), clamps a
    read index and drops a write out of range; the port follows it with a
    device index."""
    rng = np.random.default_rng(3)
    L = 4
    s = ts.ekfslam_init(torch.zeros(3), L, device="cpu")
    j = js.ekfslam_init(jnp.zeros(3), L)
    for lm in range(3):
        z = _obs(np.zeros(3), rng.uniform(-3, 3, 2), rng, 0.01)
        s = ts.ekfslam_observe(s, lm, t(z), 1e-3)
        j = js.ekfslam_observe(j, lm, jnp.asarray(z), 1e-3)
    z = np.asarray([1.5, 0.4], np.float32)
    got = ts.ekfslam_observe(s, torch.tensor(lm_id), t(z), 1e-3)
    want = jax.jit(js.ekfslam_observe)(j, lm_id, jnp.asarray(z), 1e-3)
    close(got.mean, want.mean)
    close(got.cov, want.cov)
    np.testing.assert_array_equal(got.lm_valid.numpy(), np.asarray(want.lm_valid))


# -- fastSLAM -------------------------------------------------------------------


def fast_state(st) -> ts.FastSlamState:
    return ts.FastSlamState(*(torch.from_numpy(np.array(x)) for x in st))


def check_fast(got, want, atol=ATOL):
    for name, a, b in zip(want._fields, got, want):
        if b.dtype == bool:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            close(a, b, atol=atol, rtol=RTOL)


def resample_ties(log_w, u0, p):
    """Lanes of a systematic resample whose point lies within 4 float32
    ulps of a step of JAX's CDF: there the two packages' cumulative sums
    (another order) may pick the neighbouring particle."""
    cdf = np.asarray(jnp.cumsum(jax.nn.softmax(jnp.asarray(log_w))))
    pts = np.float32(u0) + np.arange(p, dtype=np.float32) / np.float32(p)
    gap = np.min(np.abs(cdf[None, :] - pts[:, None]), axis=1)
    return gap <= 4 * np.spacing(np.float32(1.0))


def test_fastslam_tracks_and_maps_with_jax_draws():
    """``tests/test_fusion_schemes.py``'s fastSLAM run (128 particles, 2
    landmarks, 25 steps): every step starts both packages from JAX's state
    and feeds the port JAX's draws. Poses, log-weights and maps follow;
    resample indices agree on every lane away from a CDF tie."""
    lms = np.asarray([[2.0, 1.0], [-1.0, 2.0]], np.float32)
    p = 128
    key = jax.random.PRNGKey(0)
    j = js.fastslam_init(jnp.zeros(3), n_particles=p, max_landmarks=4)
    check_fast(ts.fastslam_init(torch.zeros(3), p, 4, device="cpu"), j, atol=0)
    rng = np.random.default_rng(1)
    pose = np.zeros(3, np.float32)
    predict = jax.jit(js.fastslam_predict)
    observe = jax.jit(js.fastslam_observe)
    sigma = np.asarray([0.01, 0.01, 0.005], np.float32)
    resamples = ties = 0
    for _ in range(25):
        m = np.asarray([0.08, 0.0, 0.04], np.float32)
        key, k1, k2 = jax.random.split(key, 3)
        noise = np.asarray(jax.random.normal(k1, (p, 3)))
        want = predict(j, k1, jnp.asarray(m), jnp.asarray(sigma))
        got = ts.fastslam_predict_with_noise(fast_state(j), t(m), t(sigma), t(noise))
        check_fast(got, want)
        j = want
        pose = np.asarray(jse2.compose(jnp.asarray(pose), jnp.asarray(m)))
        for lm in range(2):
            z = _obs(pose, lms[lm], rng, 0.01)
            want = observe(j, lm, jnp.asarray(z), 1e-3)
            got = ts.fastslam_observe(fast_state(j), torch.tensor(lm), t(z), 1e-3)
            check_fast(got, want)
            j = want
        neff = float(js.fastslam_neff(j))
        np.testing.assert_allclose(float(ts.fastslam_neff(fast_state(j))), neff, rtol=1e-5)
        if neff < 64:
            u0 = jax.random.uniform(k2, (), minval=0.0, maxval=1.0 / p)
            want = js.fastslam_resample(j, k2)
            got = ts.fastslam_resample_at(fast_state(j), torch.tensor(np.float32(u0)))
            tie = resample_ties(j.log_w, u0, p)
            ok = ~tie
            for a, b in zip(got[:1] + got[2:], want[:1] + want[2:]):
                np.testing.assert_array_equal(a.numpy()[ok], np.asarray(b)[ok])
            assert not got.log_w.any()
            resamples += 1
            ties += int(tie.sum())
            j = want
    assert resamples >= 3
    assert ties == 0, f"{ties} lanes of {resamples} resamples within 4 ulps of a CDF step"
    est_pose, est_map = ts.fastslam_estimate(fast_state(j))
    jpose, jmap = js.fastslam_estimate(j)
    close(est_pose, jpose)
    close(est_map, jmap)
    assert np.allclose(est_pose.numpy()[:2], pose[:2], atol=0.25)
    assert np.allclose(est_map.numpy()[:2], lms, atol=0.3)


def test_fastslam_runs_on_its_generator():
    """The sampling halves draw from a ``torch.Generator`` on its device:
    the same seed gives the same run, and the filter tracks."""
    lms = np.asarray([[2.0, 1.0], [-1.0, 2.0]], np.float32)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        s = ts.fastslam_init(torch.zeros(3), 128, 4, device="cpu")
        pose = np.zeros(3, np.float32)
        rng = np.random.default_rng(1)
        for _ in range(25):
            m = np.asarray([0.08, 0.0, 0.04], np.float32)
            s = ts.fastslam_predict(s, gen, t(m), t([0.01, 0.01, 0.005]))
            pose = np.asarray(jse2.compose(jnp.asarray(pose), jnp.asarray(m)))
            for lm in range(2):
                s = ts.fastslam_observe(s, lm, t(_obs(pose, lms[lm], rng, 0.01)), 1e-3)
            if float(ts.fastslam_neff(s)) < 64:
                s = ts.fastslam_resample(s, gen)
        return s, pose

    a, pose = run(7)
    b, _ = run(7)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    est_pose, est_map = ts.fastslam_estimate(a)
    assert np.allclose(est_pose.numpy()[:2], pose[:2], atol=0.25)
    assert np.allclose(est_map.numpy()[:2], lms, atol=0.3)


def test_fastslam_resample_resets_weights():
    s = ts.fastslam_init(torch.zeros(3), n_particles=16, max_landmarks=2, device="cpu")
    s = s._replace(log_w=torch.arange(16.0))
    s2 = ts.fastslam_resample(s, torch.Generator().manual_seed(0))
    assert np.allclose(s2.log_w.numpy(), 0.0)
    # heavy particles dominate the resampled set
    assert float(torch.mean(s2.poses[:, 0])) == 0.0  # poses identical here
    assert float(ts.fastslam_neff(s2)) == 16.0
    want = js.fastslam_resample(js.fastslam_init(jnp.zeros(3), 16, 2)._replace(log_w=jnp.arange(16.0)),
                                jax.random.PRNGKey(0))
    u0 = jax.random.uniform(jax.random.PRNGKey(0), (), minval=0.0, maxval=1.0 / 16)
    got = ts.fastslam_resample_at(s, torch.tensor(np.float32(u0)))
    check_fast(got, want, atol=0)
