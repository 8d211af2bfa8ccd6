"""Port parity: ``mapping/incremental.IncrementalMapper`` and the grid
helpers the online path needs (``occupied_points``, ``probability`` /
``occupied`` / ``known``, ``cell_centers_world``) against the JAX package,
on box-room scans made with numpy.

How grids are held. The port's ``integrate_scans`` finds a sample's cell
with a multiplication by the float32 reciprocal of the resolution, as XLA
compiles the division inside ``jit``; the JAX mapper's ``add`` is jitted,
so ``add`` is the like-for-like reference. What remains is the last bit
of ``cos``/``sin`` between the packages: a free-space sample on a cell
edge may fall into the neighbouring cell, so two grids are equal up to a
handful of cells, each by one sample's increment (``test_torch_slice.py``
holds ``integrate_scans`` the same way).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.mapping import incremental as jinc
from laser_slam_tpu.mapping import occupancy as jocc
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.mapping import incremental as tinc
from laser_slam_tpu_torch.mapping import occupancy as tocc

from tests.conftest import box_room_ranges

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
# A cell that one edge sample reaches in one package only differs by that
# sample's increment (0.13 at most in this room). On this fixture no cell
# differs against the jitted reference, and 4 against JAX's eager rebase.
MAX_EDGE_CELLS = 6
MAX_EDGE_CELLS_TRUE_DIVISION = 40


def room_session(n=10, seed=2):
    rng = np.random.default_rng(seed)
    poses = np.stack([np.asarray([0.2 * i, 0.1 * np.sin(i), 0.15 * i], np.float32) for i in range(n)])
    ranges = np.stack([box_room_ranges(MODEL, p) for p in poses])
    ranges = (ranges + rng.normal(0, 0.01, ranges.shape)).astype(np.float32)
    js = jpp.preprocess(jnp.asarray(ranges), MODEL)
    ts = interop.scan_from_numpy(*(np.asarray(x) for x in js))
    return poses, js, ts


def row(s, i):
    return type(s)(*(x[i] for x in s))


def mappers(poses, js, ts, **kw):
    jm = jinc.IncrementalMapper(MODEL, resolution=0.1, half_size=12.0, **kw)
    tm = tinc.IncrementalMapper(TMODEL, resolution=0.1, half_size=12.0, device="cpu", **kw)
    for i, p in enumerate(poses):
        jm.add(row(js, i), p)
        tm.add(row(ts, i), p)
    return jm, tm


def assert_grids_close(got: np.ndarray, want: np.ndarray, max_cells=MAX_EDGE_CELLS):
    differ = np.abs(got - want) > 1e-4
    assert differ.sum() <= max_cells, f"{differ.sum()} cells differ"
    np.testing.assert_allclose(got, want, atol=0.3)      # at most a sample or two


def test_add_matches_jax_and_one_batch_integration():
    poses, js, ts = room_session()
    jm, tm = mappers(poses, js, ts)
    assert tm.spec == tocc.GridSpec2D(**dataclasses.asdict(jm.spec))
    got = tm.grid.log_odds.numpy()
    assert_grids_close(got, np.asarray(jm.grid.log_odds))
    # N adds against one batch call of the port's own integrate_scans:
    # the same samples; the sums differ in order, and a cell that passes
    # the clamp between two adds stays clamped.
    batch = tocc.integrate_scans(tocc.empty_grid(tm.spec), TMODEL, ts, torch.from_numpy(poses))
    free = (got > tocc.LO_MIN + 1e-3) & (got < tocc.LO_MAX - 1e-3)
    np.testing.assert_allclose(got[free], batch.log_odds.numpy()[free], atol=1e-4)
    assert np.array_equal(got > 0, batch.log_odds.numpy() > 0)
    assert len(tm._scans) == len(poses) and tm._poses[3].dtype == np.float32


def test_rebase_covers_and_gate_match_jax():
    poses, js, ts = room_session()
    jm, tm = mappers(poses, js, ts)
    small = poses + np.asarray([0.05, -0.05, 0.01], np.float32)
    assert jm.needs_rebase(small) is False and tm.needs_rebase(small) is False
    moved = poses.copy()
    moved[4:, 0] += 0.4
    moved[:, 2] += 0.02
    assert jm.needs_rebase(moved) and tm.needs_rebase(moved)
    turned = poses.copy()
    turned[2, 2] += 0.06
    assert jm.needs_rebase(turned) and tm.needs_rebase(turned)
    # The rebased grid: JAX's rebase integrates outside jit (a true
    # division for the cell index), so the like-for-like reference is the
    # jitted batch integration; JAX's own rebase is held more loosely.
    tm.rebase(moved)
    jm.rebase(moved)
    ref = jax.jit(lambda g, s, p: jocc.integrate_scans(g, MODEL, s, p))(
        jocc.empty_grid(jm.spec), js, jnp.asarray(moved))
    assert_grids_close(tm.grid.log_odds.numpy(), np.asarray(ref.log_odds))
    assert_grids_close(tm.grid.log_odds.numpy(), np.asarray(jm.grid.log_odds), max_cells=MAX_EDGE_CELLS_TRUE_DIVISION)
    np.testing.assert_array_equal(np.stack(tm._poses), np.stack(jm._poses))
    for m in (jm, tm):
        assert m.covers(moved) and m.covers(moved, margin=5.0) and m.covers([])
        assert not m.covers(moved + np.asarray([20.0, 0, 0], np.float32))
        assert not m.covers(moved, margin=11.0)
    # keep_history=False: nothing to rebase from.
    jn, tn = mappers(poses[:3], js, ts, keep_history=False)
    before = tn.grid.log_odds.clone()
    tn.rebase(moved[:3])
    assert torch.equal(tn.grid.log_odds, before) and not tn.needs_rebase(moved)


def test_local_crop_matches_jax_and_does_not_alias_the_grid():
    poses, js, ts = room_session()
    jm, tm = mappers(poses[:6], js, ts)
    for pose, half in ((poses[3], 16), ((-11.9, 11.9, 0.0), 32), ((50.0, -50.0, 0.0), 8)):
        jw, jspec = jm.local_crop(pose, half)
        tw, tspec = tm.local_crop(pose, half)
        assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
        assert tw.shape == (2 * half, 2 * half)
        assert_grids_close(tw.numpy(), np.asarray(jw))
    # The window a callback holds must not change when the map goes on.
    win, _ = tm.local_crop(poses[3], 16)
    held = win.clone()
    assert win.data_ptr() != tm.grid.log_odds.data_ptr() and win._base is None
    for i in range(6, 10):
        tm.add(row(ts, i), poses[i])
    tm.grid.log_odds.add_(1.0)
    assert torch.equal(win, held)


def test_occupied_points_and_grid_properties_match_jax():
    poses, js, ts = room_session()
    jgrid = jocc.integrate_scans(jocc.empty_grid(jocc.GridSpec2D(-6.0, -7.0, 0.1, 140, 130)),
                                 MODEL, js, jnp.asarray(poses))
    # The same log-odds on both sides, so that ranks can be held exactly.
    tgrid = interop.grid_from_numpy(np.asarray(jgrid.log_odds), dataclasses.asdict(jgrid.spec))
    np.testing.assert_allclose(tgrid.probability.numpy(), np.asarray(jgrid.probability), atol=1e-6)
    np.testing.assert_array_equal(tgrid.occupied.numpy(), np.asarray(jgrid.occupied))
    np.testing.assert_array_equal(tgrid.known.numpy(), np.asarray(jgrid.known))
    cells = np.asarray([[0, 0], [3, 7], [139, 129]])
    np.testing.assert_allclose(tgrid.spec.cell_centers_world(torch.from_numpy(cells)).numpy(),
                               np.asarray(jgrid.spec.cell_centers_world(jnp.asarray(cells))), atol=1e-6)
    n_occ = int(np.asarray(jgrid.occupied).sum())
    # Ties are the rule: wall cells seen by many scans sit at the clamp.
    lo = np.asarray(jgrid.log_odds)
    vals, counts = np.unique(lo[lo > 0], return_counts=True)
    assert counts.max() > 1, "the fixture has no tie among occupied cells"
    for k in (n_occ + 40, n_occ // 2, 16):       # all of them / a cut inside the ties
        jp, jv = jocc.occupied_points(jgrid, k)
        tp, tv = tocc.occupied_points(tgrid, k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        ok = np.asarray(jv)
        np.testing.assert_allclose(tp.numpy()[ok], np.asarray(jp)[ok], atol=1e-6)
        assert tp.shape == (k, 2) and tp.dtype == torch.float32
    assert int(tv.sum()) == 16
