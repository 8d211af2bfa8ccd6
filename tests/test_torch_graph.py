"""Port parity: the pose-graph solver of ``laser_slam_tpu_torch`` against
``laser_slam_tpu`` on the same graphs (made from a numpy seed), and
``_solve_with_bank`` replayed on the committed loop banks of three real
logs (``diag/r5_*.npz``), which needs no log."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on the CPU; one intra-op thread each
# keeps torch's thread pools from oversubscribing it.
torch.set_num_threads(1)

from laser_slam_tpu.core import se2 as jse2
from laser_slam_tpu.eval import metrics as jmetrics
from laser_slam_tpu.graph import solve as jsolve
from laser_slam_tpu.runtime import slam as jslam
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.eval import metrics as tmetrics
from laser_slam_tpu_torch.graph import solve as tsolve
from laser_slam_tpu_torch.runtime import slam as tslam

ROOT = Path(__file__).resolve().parents[1]

TERM_RTOL = 1e-4     # 3×3 block products in float32, another summation order
POSE_ATOL = 1e-3     # poses after the iterated float32 solves [m, rad]
CHI2_RTOL = 1e-3
REPLAY_ATOL = 1e-2   # anchor poses of the real-log replays [m, rad]


def loop_graph(seed=0, v=40, n_loops=12, n_bad=2, pad=3):
    """A noisy two-lap circular chain with loop edges between the laps
    (``n_bad`` of them grossly wrong) and ``pad`` inactive slots that
    hold NaN measurements. Returns the field dict of a PoseGraph."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0.0, 4.0 * np.pi, v, endpoint=False)
    gt = np.stack([4.0 * np.cos(ang), 4.0 * np.sin(ang), ang + np.pi / 2], 1)
    gt = jse2.np_relative(gt[0], gt)      # vertex 0 at the origin: the solver's gauge
    seq = [(k, k + 1) for k in range(v - 1)]
    half = v // 2
    loops = [(int(k), int(k) + half) for k in rng.choice(half, n_loops, replace=False)]
    edges = seq + loops
    meas = jse2.np_relative(gt[[a for a, _ in edges]], gt[[b for _, b in edges]])
    meas[: v - 1] += rng.normal(0, [0.03, 0.03, 0.02], (v - 1, 3))
    meas[v - 1:] += rng.normal(0, 0.01, (n_loops, 3))
    meas[v - 1: v - 1 + n_bad, :2] += 6.0          # perceptual aliases
    # Start from the integrated noisy odometry.
    poses = np.zeros((v, 3))
    poses[0] = gt[0]
    for k in range(v - 1):
        poses[k + 1] = jse2.np_compose(poses[k], meas[k])
    e = len(edges) + pad
    i = np.zeros(e, np.int32)
    j = np.zeros(e, np.int32)
    i[: len(edges)] = [a for a, _ in edges]
    j[: len(edges)] = [b for _, b in edges]
    m = np.full((e, 3), np.nan, np.float32)
    m[: len(edges)] = meas
    info = np.tile(np.eye(3, dtype=np.float32) * 10.0, (e, 1, 1))
    info[: v - 1] *= 5.0
    info += 0.1 * rng.normal(size=(e, 1, 1)).astype(np.float32) ** 2 * np.eye(3, dtype=np.float32)
    active = np.arange(e) < len(edges)
    kernel = (np.arange(e) >= v - 1).astype(np.int32)
    return dict(poses=poses.astype(np.float32), v_active=np.ones(v, bool), i=i, j=j, meas=m,
                info=info, e_active=active, kernel=kernel), gt


def both(fields):
    jg = jsolve.PoseGraph(**{k: jnp.asarray(v) for k, v in fields.items()})
    tg = interop.state_from_numpy(tsolve.PoseGraph, fields)
    return jg, tg


def test_edge_jacobians_match_autograd_and_jax():
    fields, _ = loop_graph(seed=1, pad=0)
    jg, tg = both(fields)
    Ji, Jj = tsolve.edge_jacobians(tg)
    jJi, jJj = jsolve.edge_jacobians(jg)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(jJi), atol=1e-6)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(jJj), atol=1e-6)
    np.testing.assert_allclose(tsolve.edge_residuals(tg).numpy(),
                               np.asarray(jsolve.edge_residuals(jg)), atol=1e-5)
    # Against torch.autograd, away from the angle wrap.
    v = tg.poses.shape[0]
    full = torch.autograd.functional.jacobian(
        lambda p: tsolve.edge_residuals(tg._replace(poses=p)), tg.poses.double()
    ).float()                                              # [E, 3, V, 3]
    e = torch.arange(tg.i.shape[0])
    np.testing.assert_allclose(Ji.numpy(), full[e, :, tg.i].numpy(), atol=1e-4)
    np.testing.assert_allclose(Jj.numpy(), full[e, :, tg.j].numpy(), atol=1e-4)
    assert full.shape[2] == v


def test_edge_terms_and_normal_system():
    """Huber on the chain, DCS on the loops, NaN in inactive slots."""
    fields, _ = loop_graph(seed=2)
    jg, tg = both(fields)
    for got, want in zip(tsolve._edge_terms(tg), jsolve._edge_terms(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=TERM_RTOL,
                                   atol=TERM_RTOL * np.abs(want).max())
    H, b, chi = tsolve.assemble_normal_system(tg)
    jH, jb, jchi = jsolve.assemble_normal_system(jg)
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=TERM_RTOL,
                               atol=TERM_RTOL * float(np.abs(jH).max()))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=TERM_RTOL,
                               atol=TERM_RTOL * float(np.abs(jb).max()))
    np.testing.assert_allclose(float(chi), float(jchi), rtol=TERM_RTOL)
    np.testing.assert_allclose(float(tsolve.chi2(tg)), float(jsolve.chi2(jg)), rtol=TERM_RTOL)
    assert np.isfinite(H.numpy()).all()
    # The gauge-anchored, damped solve.
    dx = tsolve._chol_solve_damped(tg, H, b, 1e-4)
    jdx = jsolve._chol_solve_damped(jg, jH, jb, jnp.float32(1e-4))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=POSE_ATOL)
    # One undamped Gauss-Newton step.
    stepped, chi_gn = tsolve.gn_step(tg)
    jstepped, jchi_gn = jsolve.gn_step(jg)
    np.testing.assert_allclose(stepped.poses.numpy(), np.asarray(jstepped.poses), atol=POSE_ATOL)
    np.testing.assert_allclose(float(chi_gn), float(jchi_gn), rtol=TERM_RTOL)


@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_optimize(solver):
    fields, gt = loop_graph(seed=3)
    jg, tg = both(fields)
    want, jchi = jax.jit(lambda g: jsolve.optimize(g, 20, solver=solver))(jg)
    got, chi = tsolve.optimize(tg, 20, solver=solver)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=POSE_ATOL)
    np.testing.assert_allclose(float(chi), float(jchi), rtol=CHI2_RTOL)
    # The solve pulled the second lap onto the first (the aliases are
    # down-weighted by DCS).
    before = np.abs(fields["poses"][:, :2] - gt[:, :2]).max()
    after = np.abs(got.poses.numpy()[:, :2] - gt[:, :2]).max()
    assert after < 0.5 * before


def test_cg_step_matches_dense_step():
    fields, _ = loop_graph(seed=4)
    jg, tg = both(fields)
    dx_cg, chi_cg = tsolve._cg_solve_normal(tg, 1e-4, cg_iters=400, tol=1e-7)
    dx, chi = tsolve._solve_normal(tg, 1e-4)
    jdx, _ = jax.jit(lambda g: jsolve._cg_solve_normal(g, jnp.float32(1e-4), 400, 1e-7))(jg)
    np.testing.assert_allclose(dx_cg.numpy(), np.asarray(jdx), atol=POSE_ATOL)
    np.testing.assert_allclose(dx_cg.numpy(), dx.numpy(), atol=5e-3)
    np.testing.assert_allclose(float(chi_cg), float(chi), rtol=1e-6)


def jax_lm_steps(fn, g, max_iters):
    """The number of LM steps JAX's ``fn(g, max_iters)`` accepted: its
    result with a budget of k iterations (a traced argument, one compile)
    changes from k-1 to k exactly when iteration k accepted a step."""
    run = jax.jit(fn)
    outs = [np.asarray(run(g, k)[0].poses) for k in range(max_iters + 1)]
    return sum(not np.array_equal(a, b) for a, b in zip(outs, outs[1:]))


def test_linear_initialize_and_optimize_with_init():
    """LAGO's linear solves are held to JAX's at 1e-3. The LM polish after
    them ends in a flat valley of the cost: its last steps lower χ² by
    about 1e-6 while moving poses by mm, and LM stops once three steps in
    a row lower it by less than 1e-5. Whether a sub-threshold step is
    accepted (χ² lower by round-off) depends on the machine's BLAS and
    LAPACK, so the two packages may stop a step apart with poses 2 mm
    apart. Hence the poses are held to JAX's at 1e-3 only when both
    accepted the same number of steps; otherwise each side's χ² to the
    other's, both to the ground truth, and each side's end to be a
    stationary point within the stop rule: LM restarted there lowers χ²
    by less than three sub-threshold steps can."""
    fields, gt = loop_graph(seed=5, n_bad=1)
    # A start LM cannot leave: the second lap turned by 2.5 rad about its start.
    half = fields["poses"].shape[0] // 2
    p = fields["poses"].copy()
    turn = np.asarray([0.0, 0.0, 2.5], np.float32)
    p[half:] = jse2.np_compose(
        jse2.np_compose(p[half], turn), jse2.np_relative(p[half], p[half:]))
    fields["poses"] = p.astype(np.float32)
    jg, tg = both(fields)
    want = jax.jit(jsolve.linear_initialize)(jg)
    got = tsolve.linear_initialize(tg)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=POSE_ATOL)
    want, jchi = jax.jit(lambda g: jsolve.optimize_with_init(g, 20))(jg)
    lm = {}
    got, chi = tsolve.optimize_with_init(tg, 20, info=lm)
    steps = lm["steps"]
    jsteps = jax_lm_steps(jsolve.optimize_with_init, jg, 20)
    np.testing.assert_allclose(float(chi), float(jchi), rtol=CHI2_RTOL)
    if steps == jsteps:
        np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=POSE_ATOL)
    else:
        for end in (got.poses, torch.from_numpy(np.array(want.poses))):
            g_end = tg._replace(poses=end)
            before = float(tsolve.weighted_chi2(g_end))
            after = float(tsolve.optimize(g_end, 20)[1])
            assert before - after < 3 * tsolve.CHI2_REL_TOL, (steps, jsteps, before, after)
    for poses in (got.poses.numpy(), np.asarray(want.poses)):
        d = poses - gt
        assert np.abs(d[:, :2]).max() < 0.5 and np.abs(jse2.np_normalize_angle(d[:, 2])).max() < 0.2
    # State goes back as it came.
    back = interop.state_to_numpy(got)
    assert back["i"].dtype == np.int32 and np.array_equal(back["i"], fields["i"])


def test_nanmedian_averages_the_middle_pair():
    """``_solve_with_bank`` scales loop information by the median over the
    active loops; an even count averages the two middle values, as
    ``jnp.nanmedian`` does (``torch.nanmedian`` returns the lower)."""
    x = np.asarray([5.0, 1.0, 9.0, 3.0, 7.0, 100.0], np.float32)
    for n_act in (0, 1, 4, 5, 6):
        act = np.arange(6) < n_act
        want = jnp.nanmedian(jnp.where(jnp.asarray(act), jnp.asarray(x), jnp.nan))
        got = tslam._nanmedian_active(torch.from_numpy(x), torch.from_numpy(act))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,atol", [("intel-lab", 5e-2), ("fr079", REPLAY_ATOL),
                                       ("mit-cscail", REPLAY_ATOL)])
def test_solve_with_bank_replays_real_bank(name, atol):
    """The robust solve over a real log's anchor chain and loop bank, as
    ``tools/exp/replay_solve.py`` replays it (``bank_cov=None``: the
    files hold no covariances): the same loops used, the same poses, the
    same ATE of the re-attached trajectory.

    intel-lab's chain has fractured (hinge) edges of weight 1e-3, and LM
    reaches its iteration cap before those soft modes have converged, so
    the end state keeps a trace of the float32 round-off of the 534² and
    801² LU solves (condition ~1e6): up to 2.4 cm between XLA's and
    LAPACK's LU, and as much between LAPACK at one and at four threads.
    Its poses are held to 5 cm and its ATE to 5 mm."""
    d = np.load(ROOT / "diag" / f"r5_{name}.npz")
    odo = d["odo_anchor"].astype(np.float32)
    rel_seq = jse2.np_relative(odo[:-1], odo[1:]).astype(np.float32)
    bank = interop.bank_from_numpy({k: d["bank_" + k] for k in
                                    ("src", "dst", "rel", "q", "act", "strict")})
    args = (odo, odo, rel_seq, d["seq_weight"], bank["src"], bank["dst"], bank["rel"],
            bank["q"], bank["act"], bank["strict"])
    jcfg = jslam.SlamConfig()
    want = jax.jit(lambda *a: jslam._solve_with_bank(jcfg, *a))(*(jnp.asarray(a) for a in args))
    tcfg = interop.config_from_fields(interop.config_to_fields(tslam.SlamConfig()))
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    targs[4], targs[5] = targs[4].long(), targs[5].long()
    got = tslam._solve_with_bank(tcfg, *targs)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[1]) == int(want[1]) > 50
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=atol)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-2)
    # Re-attached to the log's odometry and scored against its ground truth.
    full = tslam._reattach(tcfg, got[0], torch.from_numpy(d["odo"]))
    jfull = jslam._reattach(jcfg, want[0], jnp.asarray(d["odo"]))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=atol)
    ate = float(tmetrics.ate(full, torch.from_numpy(d["gt"])).rmse)
    jate = float(jmetrics.ate(jfull, jnp.asarray(d["gt"])).rmse)
    assert abs(ate - jate) < 5e-3 and ate < 1.5, (ate, jate)
