"""Port parity: the loop-closure backend of ``laser_slam_tpu_torch`` as a
whole against ``laser_slam_tpu``. 300 scans of the synthetic floor plan
(numpy seed): the robot passes the first doorway, turns in the room
behind it and comes back through it, so anchors 10-16 are seen again from
anchors 23-29. JAX's front end runs once; its scans, odometry poses and
flags are carried across, and both packages run ``_frontend_post`` →
``build_submaps`` → ``run_correlative_rounds`` → ``_reattach`` at a reduced
``SlamConfig`` (the port's submaps are held to JAX's; its waves then run
on JAX's). Then the port alone, end to end, on the CPU."""

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
from laser_slam_tpu.eval import diagnostics as jdiag
from laser_slam_tpu.graph import submap as jsub
from laser_slam_tpu.ops import odometry as jodo
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu.runtime import slam as jslam
from laser_slam_tpu_torch import cli as tcli
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.eval import diagnostics as tdiag
from laser_slam_tpu_torch.eval import metrics as tmetrics
from laser_slam_tpu_torch.graph import submap as tsub
from laser_slam_tpu_torch.runtime import slam as tslam

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

POSE_ATOL = 2e-2      # [m, rad] final poses, after three robust solves
REL_ATOL = 1e-3       # a banked loop's relative pose
FRONT_ATOL = 1e-5     # relatives of the carried poses

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
N_SCANS = 300
# Three waves (the last one coverage-focused) of 16 candidates in chunks
# of 8, at half the rotation samples and a quarter of the point budgets.
SMALL = dict(rounds=2, cov_rounds=1, max_loops=16, verify_chunk=8, n_theta=36,
             submap_points=192, wide_points=384, n_peaks=4)
T = lambda x: torch.tensor(np.asarray(x))       # noqa: E731  (a copy, as a tensor)


@pytest.fixture(scope="module")
def log():
    ranges, gt, ts = synthetic_log.synthetic_log(n_scans=N_SCANS, n_whips=0)
    ranges = np.concatenate([ranges, np.full((N_SCANS, 1), MODEL.max_range + 1.0, np.float32)], 1)
    return ranges, gt.astype(np.float32), ts


@pytest.fixture(scope="module")
def front(log):
    """JAX's front end (preprocess and keyframe odometry, what ``_frontend``
    runs before ``_frontend_post``), as numpy: ``(scans, poses, weak,
    fracture)``."""
    ranges, _, ts = log
    js = jpp.preprocess(jnp.asarray(ranges), MODEL)
    odo = jodo.odometry_keyframe(MODEL, js, timestamps=ts)
    return (tuple(np.asarray(x) for x in js), np.asarray(odo.poses), np.asarray(odo.weak),
            np.asarray(odo.fracture))


def test_frontend_post_matches_jax(front):
    """Anchors, sequential relatives, edge weights and block ids, from the
    carried flags and with a fracture and a weak step put in by hand."""
    scans, poses, weak, fracture = front
    js, ts = jscan.Scan(*(jnp.asarray(x) for x in scans)), interop.scan_from_numpy(*scans)
    weak2, frac2 = weak.copy(), fracture.copy()
    weak2[57], frac2[121], frac2[122] = True, True, True
    jcfg = jslam.SlamConfig(weak_seq_weight=0.25)
    tcfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    for w, f in ((weak, fracture), (weak2, frac2)):
        want = jslam._frontend_post(jcfg, js, jnp.asarray(poses), jnp.asarray(w), jnp.asarray(f))
        got = tslam._frontend_post(tcfg, ts, T(poses), T(w), T(f))
        np.testing.assert_array_equal(got[0].numpy(), poses)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))          # anchor_idx
        for g, x in zip(got[2], want[2]):                                           # anchor scans
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))          # anchor poses
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=FRONT_ATOL)
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))          # seq_weight
        np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))          # block_id
    sw, bid = got[5].numpy(), got[6].numpy()
    assert sw[12] == np.float32(tslam.HINGE_WEIGHT) and sw[5] == 0.25 and sw[6] == 1.0
    assert bid[12] == 0 and bid[13] == 1 and bid[-1] == 1 and got[1].shape == (30,)


def run_backends(front):
    """Both packages' back end from the carried front end: ``(JAX's
    (anchor poses, n_loops, chi2, bank, tried, final poses), the port's,
    the number of submap points without a partner, all submap points)``."""
    scans, poses, weak, fracture = front
    jcfg = jslam.SlamConfig(**SMALL)
    tcfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    assert interop.config_to_fields(tcfg) == dataclasses.asdict(jcfg)

    js = jscan.Scan(*(jnp.asarray(x) for x in scans))
    (_, _, _, ap, rel_seq, seq_w, bid) = jslam._frontend_post(
        jcfg, js, jnp.asarray(poses), jnp.asarray(weak), jnp.asarray(fracture))
    jsm = jax.jit(lambda s, p: jsub.build_submaps(
        MODEL, s, p, jcfg.anchor_stride, jcfg.submap_points))(js, jnp.asarray(poses))
    out = jslam.run_correlative_rounds(jcfg, jsm, ap, rel_seq, seq_w,
                                       odo_anchor_poses=ap, block_id=bid)
    want = (*out, np.asarray(jslam._reattach(jcfg, out[0], jnp.asarray(poses))))

    ts = interop.scan_from_numpy(*scans)
    (_, _, _, ap, rel_seq, seq_w, bid) = tslam._frontend_post(
        tcfg, ts, T(poses), T(weak), T(fracture))
    tsm = tsub.build_submaps(TMODEL, ts, T(poses), tcfg.anchor_stride, tcfg.submap_points)
    timing = {}
    # The waves start from JAX's submaps, carried across: a point at a voxel
    # edge that only one package keeps (counted below) can move a tentative
    # match across one of its gates, and the banks are held to be identical.
    carried = interop.state_from_numpy(tsub.Submaps, {k: np.asarray(v) for k, v in jsm._asdict().items()})
    out = tslam.run_correlative_rounds(tcfg, carried, ap, rel_seq, seq_w,
                                       odo_anchor_poses=ap, block_id=bid, timing=timing)
    got = (*out, tslam._reattach(tcfg, out[0], T(poses)).numpy())
    assert [len(timing[k]) for k in ("bookkeeping", "propose", "verify", "solve")] == [3] * 4
    assert timing["signature_gate"] > 0 and timing["wide_clouds"] > 0

    # The submaps both back ends started from: the same clouds, up to the
    # points at a voxel edge (see tests/test_torch_submap.py).
    off = 0
    for gp, go, wp, wo in zip(tsm.points.numpy(), tsm.valid.numpy(),
                              np.asarray(jsm.points), np.asarray(jsm.valid)):
        d = np.abs(gp[go][:, None, :] - wp[wo][None, :, :]).max(-1) <= 1e-5
        off += int((~d.any(1)).sum() + (~d.any(0)).sum())
    return want, got, off, int(np.asarray(jsm.valid).sum())


@pytest.fixture(scope="module")
def backend(front):
    return run_backends(front)


def test_backend_banks_the_same_loops_as_jax(backend):
    want, got, off, total = backend
    assert off <= 0.005 * total, (off, total)
    jb, tb = want[3], got[3]
    n = int(tb["act"].sum())
    assert n == int(jb["act"].sum()) >= 6
    # Bank membership (src, dst, strict) is identical; the bank is ordered
    # by quality, which may swap two neighbours, so it is compared as a set.
    def members(b):
        a = b["act"]
        return sorted(zip(b["src"][a].tolist(), b["dst"][a].tolist(), b["strict"][a].tolist()))
    assert members(tb) == members(jb)
    assert (tb["act"] & tb["strict"]).sum() >= 4 and (tb["act"] & ~tb["strict"]).sum() >= 1
    key = lambda b: np.lexsort((b["dst"][b["act"]], b["src"][b["act"]]))       # noqa: E731
    jo, to = key(jb), key(tb)
    np.testing.assert_allclose(tb["rel"][:n][to], jb["rel"][:n][jo], atol=REL_ATOL)
    np.testing.assert_allclose(tb["q"][:n][to], jb["q"][:n][jo], atol=REL_ATOL)
    np.testing.assert_allclose(tb["cov"][:n][to], jb["cov"][:n][jo], rtol=1e-2, atol=1e-9)
    np.testing.assert_array_equal(tb["used"][:n][to], jb["used"][:n][jo])
    assert int(got[1]) == int(want[1]) == tb["used"].sum() >= 4
    # The pairs already verified.
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert got[4].sum() > n
    assert tb["src"].dtype == np.int32 and tb["rel"].dtype == np.float32
    again = interop.bank_from_numpy(tb)
    assert all(np.array_equal(again[k], tb[k]) and again[k].dtype == tb[k].dtype for k in tb)


def test_backend_poses_match_jax_and_close_the_loop(backend, log):
    want, got, _, _ = backend
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=POSE_ATOL)
    np.testing.assert_allclose(got[5], want[5], atol=POSE_ATOL)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=5e-2, atol=1e-3)
    assert got[5].shape == (N_SCANS, 3) and np.isfinite(got[5]).all()


def test_diagnostics_match_jax(backend, front, log):
    """``classify_loops``, ``loop_coverage``, ``aligned_errors`` and
    ``segment_errors`` on the back end's bank and trajectory."""
    _, got, _, _ = backend
    gt = log[1]
    bank = got[3]
    gt_anchor = gt[::10]
    # Some loops made wrong, so that both classes occur.
    rel = bank["rel"].copy()
    rel[1, 0] += 0.8
    rel[2, 2] += 0.3
    for active in (bank["used"], bank["act"]):
        want = jdiag.classify_loops(bank["src"], bank["dst"], rel, active, gt_anchor)
        rep = tdiag.classify_loops(bank["src"], bank["dst"], rel, active, gt_anchor)
        assert (rep.n, rep.n_correct) == (want.n, want.n_correct)
        for f in ("gap", "src", "dst"):
            np.testing.assert_array_equal(getattr(rep, f), np.asarray(getattr(want, f)), err_msg=f)
        np.testing.assert_allclose(rep.t_err, want.t_err, atol=1e-5)
        np.testing.assert_allclose(rep.r_err, want.r_err, atol=1e-5)
        # The same loops are called right and wrong.
        np.testing.assert_array_equal((rep.t_err < 0.5) & (rep.r_err < 0.2),
                                      (want.t_err < 0.5) & (want.r_err < 0.2))
    assert rep.n == bank["act"].sum() and 2 <= rep.n - rep.n_correct < rep.n
    np.testing.assert_array_equal(
        tdiag.loop_coverage(bank["src"], bank["dst"], bank["act"], 30),
        np.asarray(jdiag.loop_coverage(bank["src"], bank["dst"], bank["act"], 30)))
    est = got[5]
    for g, w in zip(tdiag.aligned_errors(est, gt), jdiag.aligned_errors(est, gt)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    for g, w in zip(tdiag.segment_errors(est, gt, 64), jdiag.segment_errors(est, gt, 64)):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)


@pytest.fixture(scope="module")
def log_file(log, tmp_path_factory):
    ranges, gt, ts = log
    path = str(tmp_path_factory.mktemp("slam") / "synthetic.log")
    synthetic_log.write_carmen(path, ranges[:, :180], gt.astype(np.float64), ts)
    return path


def test_slam_offline_closes_the_loop_on_the_cpu(log_file):
    """The port alone, end to end: its own odometry, submaps, waves and
    re-attachment on CPU tensors. The loop closures bring the trajectory
    closer to the ground truth than the odometry was, and most of the
    loops the last solve used are right."""
    from laser_slam_tpu_torch.io.carmen import read_carmen

    lg = read_carmen(log_file)
    cfg = tslam.SlamConfig(**SMALL)
    diag = {}
    res = tslam.slam_offline(lg.model, lg.ranges, cfg, diag=diag, timestamps=lg.timestamps,
                             device="cpu")
    gt = torch.from_numpy(lg.gt_pose)
    before, after = float(tmetrics.ate(res.odo_poses, gt).rmse), float(tmetrics.ate(res.poses, gt).rmse)
    assert res.poses.shape == (N_SCANS, 3) and bool(torch.isfinite(res.poses).all())
    assert after < before, (before, after)
    bank = diag["bank"]
    assert int(res.n_loops) == bank["used"].sum() >= 3
    rep = tdiag.classify_loops(bank["src"], bank["dst"], bank["rel"], bank["used"],
                               lg.gt_pose[res.anchor_idx.numpy()])
    assert rep.n == bank["used"].sum() and 2 * rep.n_correct > rep.n
    assert set(diag) >= {"bank", "anchor_poses", "odo_anchor_poses", "tried", "seq_weight", "timing"}
    assert diag["tried"].shape == (30, 30) and diag["seq_weight"].shape == (29,)
    assert {"frontend", "submaps", "reattach"} <= set(diag["timing"])


def test_slam_offline_does_not_fall_through_to_the_other_branch(log, monkeypatch):
    """Each branch runs its own rounds: ``use_correlative=False`` one ICP-
    verified ``_loop_round`` per round at a doubling radius and no
    correlative wave, the default the waves and no ``_loop_round``. (The
    ICP branch is held to JAX's in ``test_torch_loop_rounds.py``.)"""
    calls = {"round": [], "waves": 0}
    loop_round, waves = tslam._loop_round, tslam.run_correlative_rounds

    def counting_round(*args):
        calls["round"].append(args[5])
        return loop_round(*args)

    def counting_waves(*args, **kw):
        calls["waves"] += 1
        return waves(*args, **kw)

    monkeypatch.setattr(tslam, "_loop_round", counting_round)
    monkeypatch.setattr(tslam, "run_correlative_rounds", counting_waves)
    cfg = tslam.SlamConfig(use_correlative=False, rounds=3, max_loops=16)
    res = tslam.slam_offline(TMODEL, log[0][:60], cfg, device="cpu")
    assert calls == {"round": [2.0, 4.0, 8.0], "waves": 0}
    assert res.poses.shape == (60, 3) and bool(torch.isfinite(res.poses).all())
    tslam.slam_offline(TMODEL, log[0][:60], dataclasses.replace(cfg, use_correlative=True, rounds=1,
                                                                cov_rounds=0), device="cpu")
    assert calls == {"round": [2.0, 4.0, 8.0], "waves": 1}


def test_cli_slam_defaults_to_cuda_and_raises_without_one(log_file, monkeypatch):
    """Without ``--device`` ``cli slam`` runs on ``cuda``; where there is
    no CUDA device it raises and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["slam", log_file])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tslam.slam_offline(TMODEL, np.zeros((20, 181), np.float32))
    dflt = tslam.SlamConfig()
    assert (dflt.max_loops, dflt.verify_chunk, dflt.n_theta, dflt.coarse_res, dflt.submap_points,
            dflt.wide_points, dflt.wing, dflt.rounds, dflt.cov_rounds, dflt.n_peaks) == (
        512, 32, 72, 0.3, 768, 1536, 4, 6, 2, 8)
    assert dataclasses.asdict(dflt) == dataclasses.asdict(jslam.SlamConfig())
