"""Port parity: ``runtime/online.OnlineSlam`` and ``runtime/backend.
IncrementalBackend`` against the JAX package, fed the same scans one at a
time on the CPU.

As in ``test_torch_odometry.py`` the frontend is held twice: with JAX's
PSM matcher injected into the port's step, which holds the session logic
(the inline ±π fallback, discards, the odometry chain, rebases) to float
round-off, poses 1e-3; and end to end, where each pair's PSM stop may
differ by a few mm (last bits of ``atan2``/``cos``), 2e-2.

The async scheduler is timing-free in the tests: a gate holds every
backend round on its worker thread until the test lets it finish at a
fixed scan index, the same in both packages, so ``async_stats`` must come
out equal, number for number.
"""

import dataclasses
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.ops import psm as jpsm
from laser_slam_tpu.runtime import backend as jbackend
from laser_slam_tpu.runtime import online as jonline
from laser_slam_tpu.runtime import slam as jslam
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.ops import odometry as todo
from laser_slam_tpu_torch.ops import psm as tpsm
from laser_slam_tpu_torch.runtime import backend as tbackend
from laser_slam_tpu_torch.runtime import online as tonline

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

POSE_ATOL = 1e-3          # session logic alone: float32 order along the chain
END_TO_END_ATOL = 2e-2    # plus the per-pair PSM stops

# The 170-scan box loop of tests/test_online_loops.py: the port keeps its
# copy of that fixture in tools/synthetic_log.py (the same formulas, the
# same seed, so the same scans).
LOOP_MODEL = jscan.LaserModel(**synthetic_log.BOX_LOOP_MODEL)


def loop_scans():
    return list(synthetic_log.box_loop_scans(170))


def small_cfg(cls):
    return dataclasses.replace(
        cls(), submap_points=256, wide_points=512, max_loops=64, verify_chunk=16,
        n_theta=24, n_peaks=4, per_dst=6, search_xy=3.0, gn_iters=10)


# Rounds are asked for at scans 70, 110 and 150 (8, 12, 16 anchors at
# optimize_every=4). The first may finish before scan 120: it saw 7
# complete groups and returns no correction; the request at 110 found it
# in flight and was folded into the pending follow-up, which starts then.
# The follow-up may finish before scan 160 (it swallowed the request at
# 150) and is applied 40 scans after its snapshot; flush drains the third
# and runs the final round.
RELEASE_AT = (120, 160)


def drive_gated(slam, backend_cls, scans, monkeypatch):
    """Feeds ``scans`` into an async session whose backend rounds wait on
    their worker thread until the scan indices of ``RELEASE_AT``; then
    flushes."""
    gate = threading.Event()
    plain_round = backend_cls.round

    def gated_round(self, *snap):
        assert gate.wait(timeout=600)
        return plain_round(self, *snap)

    monkeypatch.setattr(backend_cls, "round", gated_round)
    for i, r in enumerate(scans):
        if i in RELEASE_AT:
            gate.set()
            slam._bg_thread.join(timeout=600)
            assert not slam._bg_thread.is_alive()
            gate.clear()
        slam.feed_scan(r)
    gate.set()
    slam.flush()
    monkeypatch.setattr(backend_cls, "round", plain_round)
    return slam


def summary(slam):
    bank = slam._backend._bank
    strict = bank["act"] & bank["strict"]
    return {
        "stats": dict(slam.async_stats),
        "odo_chain": np.stack(slam._odo_chain),
        "trajectory": slam.trajectory,
        "weak": list(slam._weak), "fracture": list(slam._fracture),
        "strict": sorted(zip(bank["src"][strict].tolist(), bank["dst"][strict].tolist())),
        "n_groups": len(slam._backend._group_pts),
        "tried": np.asarray(slam._backend._tried),
    }


@pytest.fixture(scope="module")
def jax_loop_session():
    mp = pytest.MonkeyPatch()
    slam = jonline.OnlineSlam(LOOP_MODEL, cfg=small_cfg(jslam.SlamConfig), optimize_every=4,
                              incremental_map=False, async_backend=True)
    out = summary(drive_gated(slam, jbackend.IncrementalBackend, loop_scans(), mp))
    mp.undo()
    out["backend"] = slam._backend
    return out


_jax_match = {}


def jax_psm(model, ref, cur, init_pose=None):
    """JAX's batched PSM matcher behind the port's matcher interface."""
    jmodel = jscan.LaserModel(**dataclasses.asdict(model))
    if jmodel not in _jax_match:
        _jax_match[jmodel] = jax.jit(jax.vmap(lambda a, b, p: jpsm.match_psm(jmodel, a, b, p)))
    to_j = lambda s: jscan.Scan(*(jnp.asarray(x.numpy()) for x in s))
    init = jnp.zeros((cur.ranges.shape[0], 3)) if init_pose is None else jnp.asarray(init_pose.numpy())
    r = _jax_match[jmodel](to_j(ref), to_j(cur), init)
    return tpsm.MatchResult(*(torch.from_numpy(np.array(x)) for x in r))


def port_model(model):
    return interop.model_from_fields(dataclasses.asdict(model))


def test_online_session_with_jax_matcher_matches_jax(jax_loop_session, monkeypatch):
    """The whole async session on the box loop, JAX's matcher injected:
    the scheduler's counters equal JAX's, the raw odometry chain within
    1e-3, the same groups, the same strict loops in the bank and the same
    tried pairs; the rebased trajectory within 5e-2 (it went through four
    robust solves)."""
    want = jax_loop_session
    monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
    slam = tonline.OnlineSlam(port_model(LOOP_MODEL), cfg=small_cfg(tbackend.SlamConfig),
                              optimize_every=4, incremental_map=False, async_backend=True,
                              device="cpu")
    got = summary(drive_gated(slam, tbackend.IncrementalBackend, loop_scans(), monkeypatch))
    assert got["stats"] == want["stats"]
    assert got["stats"] == {"requested": 3, "started": 3, "applied": 2, "coalesced": 2,
                            "overlap_scans_max": 40}
    np.testing.assert_allclose(got["odo_chain"], want["odo_chain"], atol=POSE_ATOL)
    assert got["weak"] == want["weak"] and got["fracture"] == want["fracture"]
    assert got["n_groups"] == want["n_groups"] == 17
    assert len(want["strict"]) >= 1 and got["strict"] == want["strict"]
    np.testing.assert_array_equal(got["tried"], want["tried"])
    np.testing.assert_allclose(got["trajectory"], want["trajectory"], atol=5e-2)
    assert slam.n_loops == slam._backend.n_loops >= 1
    assert slam._bg_result is None and not slam._pending_round and not slam._bg_thread.is_alive()


def test_online_frontend_end_to_end_matches_jax(jax_loop_session):
    """The port's own matcher, no backend round (``optimize_every`` out of
    reach): the raw odometry chain of the 170 scans against the JAX
    session's, which no rebase touches."""
    slam = tonline.OnlineSlam(port_model(LOOP_MODEL), cfg=small_cfg(tbackend.SlamConfig),
                              optimize_every=10 ** 6, device="cpu")
    for r in loop_scans():
        pose = slam.feed_scan(r)
    want = jax_loop_session
    np.testing.assert_allclose(np.stack(slam._odo_chain), want["odo_chain"], atol=END_TO_END_ATOL)
    np.testing.assert_allclose(slam.trajectory, np.stack(slam._odo_chain), atol=1e-5)   # never rebased
    np.testing.assert_array_equal(pose, slam.pose)
    assert slam._weak == want["weak"] and slam._fracture == want["fracture"]
    assert slam._backend._bank is None and len(slam._scans) == 17
    # The live map covers the lap and is the grid render_map hands out.
    assert slam.render_map(slam.map_resolution) is slam._imap.grid
    assert float((slam._imap.grid.log_odds > 0).sum()) > 100
    fine = slam.render_map(0.2)
    assert fine.spec.resolution == 0.2 and float((fine.log_odds > 0).sum()) > 50
    win, wspec = slam.local_map(half_cells=20)
    assert win.shape == (40, 40) and wspec.resolution == slam.map_resolution


# -- the inline fallback: a whip and a blank frame ---------------------------

WHIP_MODEL = jscan.LMS211


def whip_scans(n=40, whip_at=20, blank_at=30, seed=40):
    """5 cm / 2° steps in the asymmetric room of ``tools/synthetic_log.py``,
    a 100° turn in place at ``whip_at`` (beyond the banded matchers: the
    step takes the ±π fallback) and a frame of no returns at ``blank_at``
    (every matcher fails: the step is discarded)."""
    rng = np.random.default_rng(seed)
    poses = [np.asarray([-1.0, 1.0, -1.0])]
    for i in range(1, n):
        x, y, th = poses[-1]
        if i == whip_at:
            poses.append(np.asarray([x, y, th + np.radians(100.0)]))
            continue
        th = th + np.radians(2.0) + rng.normal(0, 0.003)
        poses.append(np.asarray([x + 0.05 * np.cos(th), y + 0.05 * np.sin(th), th]))
    r = synthetic_log.ray_cast(synthetic_log.room_walls(), np.stack(poses),
                               np.asarray(WHIP_MODEL.bearings(), np.float64), WHIP_MODEL.max_range)
    r = np.where(r <= WHIP_MODEL.max_range, r + rng.normal(0, 0.01, r.shape), r).astype(np.float32)
    r[blank_at] = WHIP_MODEL.max_range + 1.0
    return r


@pytest.fixture(scope="module")
def jax_whip_session(tmp_path_factory):
    """The JAX session over the whip scans, and its checkpoint at scan 25."""
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_session.npz")
    slam = jonline.OnlineSlam(WHIP_MODEL, use_fusion=True)
    for i, r in enumerate(whip_scans()):
        if i == 25:
            slam.save(path)
        slam.feed_scan(r)
    return slam, path


@pytest.mark.parametrize("inject", [True, False])
def test_inline_fallback_and_discard_match_jax(jax_whip_session, inject, monkeypatch):
    jslam_, _ = jax_whip_session
    if inject:
        monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
    deep_steps, step_deep = [], tonline._step_deep

    def counting(model, carry, cur, psm_rel):
        deep_steps.append(len(slam._poses))
        return step_deep(model, carry, cur, psm_rel)

    monkeypatch.setattr(tonline, "_step_deep", counting)
    slam = tonline.OnlineSlam(port_model(WHIP_MODEL), use_fusion=True, device="cpu")
    poses = [slam.feed_scan(r) for r in whip_scans()]
    atol = POSE_ATOL if inject else END_TO_END_ATOL
    np.testing.assert_allclose(slam.trajectory, jslam_.trajectory, atol=atol)
    np.testing.assert_array_equal(np.stack(poses), slam.trajectory)
    assert slam._weak == jslam_._weak and slam._fracture == jslam_._fracture
    # Two scans took the ±π fallback, and only they: the whip kept its
    # frame as a weak step (the matchers agree on the same pose in both
    # packages, which is all that is held here); the blank frame was
    # discarded (weak, a fracture, the pose held) and the next one matched on.
    assert deep_steps == [20, 30]
    assert slam._weak[20] and slam._weak[30] and slam._fracture[30] and not slam._fracture[20]
    assert sum(slam._weak) == 2
    np.testing.assert_array_equal(slam.trajectory[30], slam.trajectory[29])
    assert 0.03 < np.linalg.norm(slam.trajectory[31, :2] - slam.trajectory[29, :2]) < 0.2
    # The filter follows the session: one fetch, the fused pose.
    np.testing.assert_allclose(slam.pose, jslam_.pose, atol=max(atol, 1e-3))
    np.testing.assert_allclose(float(slam._fusion_t), float(jslam_._fusion_t))
    np.testing.assert_allclose(np.stack(slam._odo_chain), np.stack(jslam_._odo_chain), atol=atol)


def test_beacon_and_gps_feeds_match_jax():
    """``feed_beacon`` and ``feed_gps`` (stamped, stale, unstamped) move
    the filter as JAX's do: 1e-5 on states of order 1."""
    class Fix:
        def __init__(self, east, north, t):
            self.east, self.north, self.t = east, north, t

    j = jonline.OnlineSlam(WHIP_MODEL, use_fusion=True, incremental_map=False)
    t = tonline.OnlineSlam(port_model(WHIP_MODEL), use_fusion=True, incremental_map=False,
                           device="cpu")
    for s in (j, t):
        s.feed_beacon(np.asarray([0.3, -0.1], np.float32))
        s.feed_gps(Fix(0.5, 0.2, 10.0))
        s.feed_gps(Fix(9.0, 9.0, 10.0))          # stale: skipped
        s.feed_gps(Fix(9.0, 9.0, 4.0))           # out of order: skipped
        s.feed_gps((0.4, 0.1), r=0.5)            # unstamped pair
    np.testing.assert_allclose(t.pose, j.pose, atol=1e-5)
    np.testing.assert_allclose(t._fusion.cov.numpy(), np.asarray(j._fusion.cov), atol=1e-5)
    assert np.abs(t.pose[:2]).max() < 1.0
    plain = tonline.OnlineSlam(port_model(WHIP_MODEL), incremental_map=False, device="cpu")
    plain.feed_beacon([1.0, 1.0])
    plain.feed_gps((1.0, 1.0))                   # no filter: ignored
    np.testing.assert_array_equal(plain.pose, np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="incremental_map"):
        plain.local_map()


# -- checkpoints cross between the packages ----------------------------------

def test_port_resumes_the_jax_sessions_checkpoint(jax_whip_session, monkeypatch):
    jslam_, path = jax_whip_session
    monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
    slam = tonline.OnlineSlam.resume(port_model(WHIP_MODEL), path, device="cpu")
    assert slam._t == 25 and len(slam._poses) == 25 and len(slam._all_scans) == 25
    assert len(slam._scans) == 3 and slam._carry.ref.seg.dtype == torch.int32
    for r in whip_scans()[25:]:
        slam.feed_scan(r)
    np.testing.assert_allclose(slam.trajectory, jslam_.trajectory, atol=POSE_ATOL)
    assert slam._weak == jslam_._weak and slam._fracture == jslam_._fracture
    with pytest.raises(ValueError, match="checkpoint is for model"):
        tonline.OnlineSlam.resume(port_model(LOOP_MODEL), path, device="cpu")


def test_jax_resumes_the_ports_checkpoint(jax_whip_session, tmp_path, monkeypatch):
    jslam_, jpath = jax_whip_session
    monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
    path = str(tmp_path / "port_session.npz")
    slam = tonline.OnlineSlam(port_model(WHIP_MODEL), device="cpu")
    scans = whip_scans()
    for r in scans[:25]:
        slam.feed_scan(r)
    slam.save(path)
    # The two packages write the same keys, types and shapes.
    a, b = np.load(jpath), np.load(path)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    resumed = jonline.OnlineSlam.resume(WHIP_MODEL, path)
    for r in scans[25:]:
        resumed.feed_scan(r)
    np.testing.assert_allclose(resumed.trajectory, jslam_.trajectory, atol=POSE_ATOL)
    assert resumed._weak == jslam_._weak and resumed._fracture == jslam_._fracture
    # And the port resumes its own file to the same end.
    own = tonline.OnlineSlam.resume(port_model(WHIP_MODEL), path, device="cpu")
    for r in scans[25:]:
        own.feed_scan(r)
    np.testing.assert_allclose(own.trajectory, resumed.trajectory, atol=POSE_ATOL)
    # An empty session saves and says so.
    empty = str(tmp_path / "empty.npz")
    tonline.OnlineSlam(port_model(WHIP_MODEL), device="cpu").save(empty)
    from laser_slam_tpu_torch.utils.checkpoint import load_pytree
    flat, meta = load_pytree(empty)
    assert meta["t"] == 0 and flat["all_scans"] is None and flat["carry"] is None


# -- states cross through interop -----------------------------------------------

def test_carry_and_backend_state_cross_between_the_packages(jax_whip_session, jax_loop_session,
                                                            monkeypatch):
    """The odometry carry of the JAX session, carried into the port, takes
    the next scan to the same pose (JAX's matcher injected, 1e-3); the
    incremental backend's persistent state (group clouds, bank, tried
    matrix) goes across both ways unchanged, as copies."""
    jslam_, _ = jax_whip_session
    fields = {k: tuple(np.asarray(x) for x in v) if isinstance(v, jscan.Scan) else np.asarray(v)
              for k, v in jslam_._carry._asdict().items()}
    carry = interop.named_state_from_numpy(todo._OdoCarry, fields)
    back = interop.named_state_to_numpy(carry)
    for k, v in fields.items():
        for a, b in zip(v if isinstance(v, tuple) else (v,),
                        back[k] if isinstance(v, tuple) else (back[k],)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    nxt = whip_scans(n=41)[39] * 0.999           # a scan the session has not seen
    from laser_slam_tpu.ops import preprocess as jpp
    from laser_slam_tpu_torch.ops import preprocess as tpp
    _, jout = jslam_._step_fn(jslam_._carry, jpp.preprocess(jnp.asarray(nxt), WHIP_MODEL))
    monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
    _, tout, _ = todo._step_flagged(port_model(WHIP_MODEL), carry,
                                    tpp.preprocess(torch.from_numpy(nxt), port_model(WHIP_MODEL)))
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), atol=POSE_ATOL)
    with pytest.raises(TypeError):
        interop.named_state_from_numpy(dict, fields)

    jb = jax_loop_session["backend"]
    state = interop.backend_state_to_numpy(jb)
    tb = tbackend.IncrementalBackend(port_model(LOOP_MODEL), small_cfg(tbackend.SlamConfig),
                                     device="cpu")
    interop.backend_state_from_numpy(tb, state)
    fresh = jbackend.IncrementalBackend(LOOP_MODEL, small_cfg(jslam.SlamConfig))
    interop.backend_state_from_numpy(fresh, interop.backend_state_to_numpy(tb))
    for b in (tb, fresh):
        assert len(b._group_pts) == 17 and b.n_loops == jb.n_loops >= 1
        np.testing.assert_array_equal(np.stack(b._group_pts), np.stack(jb._group_pts))
        np.testing.assert_array_equal(np.stack(b._group_ok), np.stack(jb._group_ok))
        np.testing.assert_array_equal(b._tried, jb._tried)
        assert b._bank.keys() == jb._bank.keys()
        for k in jb._bank:
            np.testing.assert_array_equal(b._bank[k], jb._bank[k])
            assert b._bank[k].dtype == np.asarray(jb._bank[k]).dtype
    tb._bank["act"][:] = False                   # a copy: the source is untouched
    assert jb._bank["act"].any()


# -- the scheduler's own rules -------------------------------------------------

def test_worker_failure_surfaces_on_the_caller(monkeypatch):
    """A round that dies on the worker thread must not let ``flush``
    return as if it had run."""
    def broken_round(self, *snap):
        raise FloatingPointError("solver blew up")

    monkeypatch.setattr(tbackend.IncrementalBackend, "round", broken_round)
    slam = tonline.OnlineSlam(port_model(LOOP_MODEL), cfg=small_cfg(tbackend.SlamConfig),
                              optimize_every=4, incremental_map=False, async_backend=True,
                              device="cpu")
    monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
    scans = loop_scans()
    for r in scans[:71]:                       # the first round starts at scan 70
        slam.feed_scan(r)
    assert slam.async_stats["started"] == 1
    with pytest.raises(RuntimeError, match="backend round failed") as info:
        slam.flush(final_round=False)
    assert isinstance(info.value.__cause__, FloatingPointError)
    # Raised once; the session itself goes on.
    slam.flush(final_round=False)
    slam._bg_thread = None
    assert slam.feed_scan(scans[71]).shape == (3,)


def test_sessions_need_a_cuda_device_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = port_model(WHIP_MODEL)
    from laser_slam_tpu_torch.mapping.incremental import IncrementalMapper

    for make in (lambda **kw: tonline.OnlineSlam(model, **kw),
                 lambda **kw: tbackend.IncrementalBackend(model, **kw),
                 lambda **kw: IncrementalMapper(model, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(device="cuda:0")
        assert make(device="cpu").device == torch.device("cpu")
