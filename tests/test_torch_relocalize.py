"""Global relocalization on the port's normal paths, on the CPU: the table
of the map's free cells and the free-space sampler
(``particle_filter.free_cells``, ``free_space_poses``), relocalization
scored by ray-cast + ICP (``global_relocalize_raycast_icp``) against the
benchmark's plain reference (``benchmark/reference/relocalize_icp.py``),
the field's relocalization drawing from free space too, ``update_icp``'s
chunk rule, ``cli localize --global`` and ``SlamV1``'s table built once
a map.

The room's sensor reaches 10 m, so the CPU's dense ladder stays short
(200 samples at 5 cm); the CLI runs on a coarse map (0.2 m cells) with
fewer samples than the reference's 10,000 (``fewer_samples``).
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch
from scipy import stats

from laser_slam_tpu_torch import cli as tcli
from laser_slam_tpu_torch.core.scan import LMS211, Scan
from laser_slam_tpu_torch.localization import particle_filter as pf
from laser_slam_tpu_torch.localization import raycast
from laser_slam_tpu_torch.mapping.occupancy import (
    GridSpec2D,
    OccupancyGrid,
    empty_grid,
    integrate_scans,
    spec_for_trajectory,
)
from laser_slam_tpu_torch.ops import icp_points
from laser_slam_tpu_torch.ops.preprocess import preprocess
from laser_slam_tpu_torch.runtime import facade as tfacade

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
import synthetic_log  # noqa: E402
from benchmark.reference import relocalize_icp as ref  # noqa: E402

torch.set_num_threads(1)

ROOM_MODEL = dataclasses.replace(LMS211, max_range=10.0)
POSES = np.asarray([(-1.0 + 0.15 * i, 1.0 - 0.05 * i, -1.0 + 0.3 * i) for i in range(10)],
                   np.float32)


def room_ranges(poses, seed=0):
    """Ranges ``[T, N]`` in the asymmetric room of ``tools/synthetic_log.py``."""
    rng = np.random.default_rng(seed)
    bearings = np.asarray(ROOM_MODEL.bearings(torch.float64), np.float64)
    r = synthetic_log.ray_cast(synthetic_log.room_walls(), np.asarray(poses, np.float64),
                               bearings, ROOM_MODEL.max_range)
    return np.where(r <= ROOM_MODEL.max_range, r + rng.normal(0, 0.01, r.shape),
                    r).astype(np.float32)


@pytest.fixture(scope="module")
def room():
    """The room's 5 cm map from ten poses and the scan taken at pose 5."""
    scans = preprocess(torch.as_tensor(room_ranges(POSES)), ROOM_MODEL)
    spec = spec_for_trajectory(POSES, ROOM_MODEL.max_range, 0.05)
    grid = integrate_scans(empty_grid(spec), ROOM_MODEL, scans, torch.as_tensor(POSES))
    return grid, scans.ranges[5], ~scans.bad[5]


def cells_of(grid, poses):
    """Each pose's cell as the port finds it (float32, ``world_to_cell``)
    and in float64, as flat indices."""
    spec = grid.spec
    ix, iy = spec.world_to_cell(poses[:, :2]).unbind(-1)
    p = poses.double()
    jx = torch.floor((p[:, 0] - spec.origin_x) / spec.resolution).long()
    jy = torch.floor((p[:, 1] - spec.origin_y) / spec.resolution).long()
    return iy * spec.width + ix, jy * spec.width + jx


def uniforms(n, seed):
    return torch.rand(n, 4, generator=torch.Generator().manual_seed(seed))


def test_free_cells_is_the_maps_table(room):
    grid = room[0]
    free = pf.free_cells(grid)
    flat = grid.log_odds.reshape(-1)
    want = np.flatnonzero(flat.numpy() < 0)
    assert free.dtype == torch.int64 and np.array_equal(free.numpy(), want)
    assert torch.equal(free, ref.free_cells(grid.log_odds))
    assert 0 < free.numel() < flat.numel()
    blind = OccupancyGrid(torch.ones_like(grid.log_odds), grid.spec)
    with pytest.raises(ValueError, match="no free cell"):
        pf.free_cells(blind)


def test_samples_lie_in_free_cells_and_follow_their_draws(room):
    grid = room[0]
    free = pf.free_cells(grid)
    u = uniforms(20000, 1)
    poses = pf.free_space_poses(free, grid.spec, u)
    assert poses.shape == (20000, 3) and poses.dtype == torch.float32
    is_free = set(free.tolist())
    for cells in cells_of(grid, poses):
        assert set(cells.tolist()) <= is_free
    assert float(poses[:, 2].min()) >= -np.pi and float(poses[:, 2].max()) < np.pi
    # Deterministic from the draws, and the reference's sampler bit for bit.
    assert torch.equal(pf.free_space_poses(free, grid.spec, u.clone()), poses)
    assert torch.equal(ref.sample(free, grid.spec, u), poses)
    assert not torch.equal(pf.free_space_poses(free, grid.spec, uniforms(20000, 2)), poses)
    # The extremes of the draws stay in their cells: u0 next to 1 takes the
    # last free cell, u1 and u2 at 0 and next to 1 keep the margin.
    edge = torch.tensor([[0.0, 0.0, 0.0, 0.0], [1.0 - 2 ** -24] * 4])
    ends = pf.free_space_poses(free, grid.spec, edge)
    for cells in cells_of(grid, ends):
        assert cells.tolist() == [int(free[0]), int(free[-1])]


def test_samples_are_uniform_over_free_space():
    """On a 7 x 5 map of mixed cells every free cell is drawn alike (a
    chi-square test of 60,000 draws), no other cell is drawn, and the
    position inside a cell is uniform over all but the margin."""
    g = torch.Generator().manual_seed(0)
    log_odds = torch.randn(5, 7, generator=g)
    log_odds[2, 3] = 0.0                             # unknown: not free
    grid = OccupancyGrid(log_odds, GridSpec2D(-1.0, -2.0, 0.5, 7, 5))
    free = pf.free_cells(grid)
    n_free = free.numel()
    assert 8 < n_free < 30
    poses = pf.free_space_poses(free, grid.spec, uniforms(60000, 3))
    cells, _ = cells_of(grid, poses)
    counts = torch.bincount(cells, minlength=35)
    assert int(counts[log_odds.reshape(-1) >= 0].sum()) == 0
    chi2 = stats.chisquare(counts[free].numpy())
    assert chi2.pvalue > 1e-3, chi2
    inside = (poses[:, :2] - torch.tensor([-1.0, -2.0])) / 0.5
    frac = (inside - torch.floor(inside)).reshape(-1)
    assert float(frac.min()) >= pf.FREE_CELL_MARGIN - 1e-4
    assert float(frac.max()) <= 1 - pf.FREE_CELL_MARGIN + 1e-4
    assert abs(float(frac.mean()) - 0.5) < 0.005
    hist = torch.histc(frac, bins=10, min=pf.FREE_CELL_MARGIN, max=1 - pf.FREE_CELL_MARGIN)
    assert stats.chisquare(hist.numpy()).pvalue > 1e-3


def test_relocalization_is_the_references(room):
    """400 free-space samples scored by ray-cast + ICP against the plain
    reference, bit for bit on the CPU; the cut at ``n_keep`` falls inside
    the tie of the failed matches (weight 1e-6), which keeps them in the
    order they were drawn, each at its own pose (no nudge)."""
    grid, ranges, valid = room
    free = pf.free_cells(grid)
    poses = pf.free_space_poses(free, grid.spec, uniforms(400, 5))
    scored, want = ref.relocalize(poses, grid, ROOM_MODEL, ranges, valid, 400)
    w = scored.log_w
    failed = w < w.max() - 7.0
    n_pass = int((~failed).sum())
    assert 20 < n_pass < 380, n_pass                  # both kinds present
    n_keep = n_pass + 10
    got = pf.global_relocalize_raycast_icp(poses, grid, ROOM_MODEL, ranges, valid, n_keep)
    _, want = ref.relocalize(poses, grid, ROOM_MODEL, ranges, valid, n_keep)
    assert torch.equal(got.poses, want.poses) and torch.equal(got.log_w, want.log_w)
    assert got.poses.shape == (n_keep, 3)
    assert torch.all(got.log_w[:-1] >= got.log_w[1:])
    assert float(torch.logsumexp(got.log_w, 0)) == pytest.approx(0.0, abs=1e-6)
    tail = got.poses[n_pass:]
    assert torch.equal(tail, poses[failed][:10])
    assert len(set(got.log_w[n_pass:].tolist())) == 1
    # The head is nudged: the kept poses of held matches moved.
    assert not torch.equal(got.poses[:n_pass], poses[~failed][:n_pass])


def test_relocalize_at_picks_the_scoring(room, monkeypatch):
    """``global_relocalize_at`` samples once and scores by ray-cast + ICP
    in ``"icp"`` mode, on the field in ``"field"`` and ``"beam"`` modes;
    ``global_relocalize`` draws its uniforms from the generator and builds
    the table where it has none."""
    grid, ranges, valid = room
    field = raycast.likelihood_field(grid)
    free = pf.free_cells(grid)
    u = uniforms(300, 7)
    calls = []
    for name in ("free_space_poses", "global_relocalize_poses", "global_relocalize_raycast_icp",
                 "free_cells"):
        _spy(monkeypatch, pf, name, calls)
    on_field = pf.global_relocalize_at(u, free, "field", grid, field, ROOM_MODEL, ranges, valid,
                                       64)
    by_icp = pf.global_relocalize_at(u, free, "icp", grid, None, ROOM_MODEL, ranges, valid, 64)
    for_beam = pf.global_relocalize_at(u, free, "beam", grid, field, ROOM_MODEL, ranges, valid,
                                       64)
    assert calls == ["free_space_poses", "global_relocalize_poses",
                     "free_space_poses", "global_relocalize_raycast_icp",
                     "free_space_poses", "global_relocalize_poses"]
    assert torch.equal(for_beam.poses, on_field.poses)
    poses = pf.free_space_poses(free, grid.spec, u)
    assert torch.equal(by_icp.poses,
                       pf.global_relocalize_raycast_icp(poses, grid, ROOM_MODEL, ranges, valid,
                                                        64).poses)
    assert torch.equal(on_field.poses,
                       pf.global_relocalize_poses(poses, grid, field, ROOM_MODEL, ranges, valid,
                                                  64).poses)
    calls.clear()
    gen = torch.Generator().manual_seed(7)
    again = pf.global_relocalize(gen, "field", grid, field, ROOM_MODEL, ranges, valid,
                                 n_samples=300, n_keep=64)
    assert calls == ["free_cells", "free_space_poses", "global_relocalize_poses"]
    assert torch.equal(again.poses, on_field.poses) and torch.equal(again.log_w, on_field.log_w)


def test_field_relocalization_draws_from_free_space(room, monkeypatch):
    """Every sample the field's relocalization scores lies in a free cell,
    so none is given the 0 of a sample outside free space: the kept
    cloud's weights are the field's likelihoods of all the samples."""
    grid, ranges, valid = room
    field = raycast.likelihood_field(grid)
    drawn = []
    real = pf.free_space_poses

    def spy(*args):
        drawn.append(real(*args))
        return drawn[-1]

    monkeypatch.setattr(pf, "free_space_poses", spy)
    gen = torch.Generator().manual_seed(11)
    state = pf.global_relocalize(gen, "field", grid, field, ROOM_MODEL, ranges, valid,
                                 n_samples=3000, n_keep=3000)
    (samples,) = drawn
    free = set(pf.free_cells(grid).tolist())
    for cells in cells_of(grid, samples):
        assert set(cells.tolist()) <= free
    lik = raycast.endpoint_likelihood(field, grid.spec, ROOM_MODEL, samples, ranges, valid)
    want = torch.sort(torch.log(lik + 1e-12), descending=True, stable=True).values
    assert state.poses.shape == (3000, 3)
    torch.testing.assert_close(state.log_w, want - torch.logsumexp(want, 0), rtol=0, atol=1e-5)


def test_update_icp_sizes_its_chunks_by_bytes_per_row(room, monkeypatch):
    """``update_icp`` asks ``icp_points.bytes_per_row`` for the bytes of a
    particle's row: with the kernel's rule (``N · BYTES_PER_POINT``) and a
    budget of five such rows, 12 particles take three chunks; with the
    plain block's rule on the CPU, one."""
    grid, ranges, valid = room
    scan_pts, scan_ok = icp_points.scan_to_points(ROOM_MODEL, Scan(ranges, ~valid, None))
    map_pts = scan_pts + 0.01
    g = torch.Generator().manual_seed(3)
    state = pf.init_gaussian(g, torch.as_tensor(POSES[5]), 12, sigma_xy=0.05, sigma_theta=0.02)
    calls = []
    real = pf.match_icp_points

    def counted(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(pf, "match_icp_points", counted)
    whole = pf.update_icp(state, map_pts, scan_ok, ROOM_MODEL, scan_pts, scan_ok)
    assert calls == [12]
    n = scan_pts.shape[0]
    calls.clear()
    monkeypatch.setattr(pf, "CHUNK_BYTES", 5 * n * icp_points.BYTES_PER_POINT)
    monkeypatch.setattr(icp_points, "bytes_per_row", lambda cur, ref: cur.shape[-2]
                        * icp_points.BYTES_PER_POINT)
    chunked = pf.update_icp(state, map_pts, scan_ok, ROOM_MODEL, scan_pts, scan_ok)
    assert calls == [5, 5, 2]
    np.testing.assert_allclose(chunked.poses.numpy(), whole.poses.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(chunked.log_w.numpy(), whole.log_w.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def small_log(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("reloc") / "synthetic.log")
    synthetic_log.write_carmen(path, *synthetic_log.synthetic_log(n_scans=60, n_whips=0))
    return path


def fewer_samples(monkeypatch, n: int):
    """The entry points relocalize from ``n`` samples in place of the
    reference's 10,000, to keep the CPU's ladder short."""
    monkeypatch.setattr(pf, "global_relocalize",
                        functools.partial(pf.global_relocalize, n_samples=n))


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("model", ["icp", "field", "beam"])
def test_cli_localize_global(small_log, monkeypatch, capsys, model):
    """``--global`` relocalizes on the first tracked scan from
    ``RELOC_SAMPLES`` free-space samples, keeping ``--particles``: with
    ``--model icp`` by ray-cast + ICP as that tick's update, no field
    built; with ``--model field`` or ``beam`` on the field, then the
    model's update.
    Every later tick predicts and updates; the run is seeded."""
    fewer_samples(monkeypatch, 400)
    args = ["--device", "cpu", "--particles", "48", "--steps", "4", "--resolution", "0.2",
            "--global", "--model", model]
    calls = []
    for module, name in ((pf, "free_cells"), (pf, "global_relocalize_raycast_icp"),
                         (pf, "global_relocalize_poses"), (pf, "update_raycast_icp"),
                         (pf, "update_field"), (pf, "update_beam"), (pf, "predict"),
                         (raycast, "likelihood_field")):
        _spy(monkeypatch, module, name, calls)
    run = tcli.main(["localize", small_log, *args])
    assert "tracked 4 steps with 48 particles: pos err mean=" in capsys.readouterr().out
    if model == "icp":
        assert calls == ["free_cells", "global_relocalize_raycast_icp", "update_raycast_icp"] + [
            "predict", "update_raycast_icp"] * 3
    else:
        update = f"update_{model}"
        assert calls == ["likelihood_field", "free_cells", "global_relocalize_poses",
                         update] + ["predict", update] * 3
    assert run.errors.shape == (4,) and run.state.poses.shape == (48, 3)
    assert np.isfinite(run.errors).all()
    again = tcli.main(["localize", small_log, *args])
    np.testing.assert_array_equal(again.errors, run.errors)


def test_facade_builds_the_free_table_once_a_map(room, monkeypatch):
    """``SlamV1`` builds the table of free cells once, at ``start``, and
    relocalizes its first scan from it (field mode: on the field)."""
    grid = room[0]
    fewer_samples(monkeypatch, 500)
    calls = []
    for name in ("free_cells", "global_relocalize", "update_field"):
        _spy(monkeypatch, pf, name, calls)
    s = tfacade.SlamV1(ROOM_MODEL, work_mode="localization", localization_grid=grid,
                       n_particles=64, device="cpu", seed=2)
    s.start()
    assert calls == ["free_cells"]
    for k in range(3):
        s.feed_odometry(0.0, 0.0, 0.0)
        s.feed_scan_main(room_ranges(POSES[5][None], seed=30 + k)[0])
    assert calls == ["free_cells", "global_relocalize"] + ["update_field"] * 3
