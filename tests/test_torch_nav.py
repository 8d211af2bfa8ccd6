"""Port parity: navigation (``nav/controller``, ``nav/planner``,
``nav/local_map``, ``nav/local_planner``, ``nav/trajectory``) of
``laser_slam_tpu_torch`` against ``laser_slam_tpu`` on the CPU.

Each test of ``test_nav.py``, ``test_local_map.py``,
``test_local_planner.py`` and ``test_trajectory.py`` runs here on the
port, and the same seeded numpy inputs go through both packages.
Tolerances:

- ``wavefront``: equal (min and add round once each, in the same order);
- ``plan_path``: ``path``, ``n_valid``, ``reached`` identical, on a free
  grid, around a wall, when blocked, and with start or goal on a cell
  edge; ``length`` 1e-5 relative (a sum of float32 hypotenuses);
- ``inflate_obstacles``: identical;
- ``update_local_map``: 1e-5 after 20 scans with moving poses,
  ``origin_cell`` equal; ``obstacle_distance_field``: 1e-5;
- ``dodge_path`` / ``milestone_select``: identical ``Milestone``;
- the trajectory functions: 1e-5;
- pure pursuit and the tracking tick: 1e-5, zones equal.

JAX runs under ``jit``, as its callers run it (``TaskEngine``,
``LocalMapService``); eager JAX divides where the compiled code multiplies
by the reciprocal, and rounds some fused multiply-adds twice. The
trajectory functions are held against eager calls, as
``plan_velocity_schedule`` makes them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.mapping import occupancy as jocc
from laser_slam_tpu.nav import controller as jctl
from laser_slam_tpu.nav import local_map as jlm
from laser_slam_tpu.nav import local_planner as jlp
from laser_slam_tpu.nav import planner as jpl
from laser_slam_tpu.nav import trajectory as jtr
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.core import refmath
from laser_slam_tpu_torch.nav import controller as tctl
from laser_slam_tpu_torch.nav import local_map as tlm
from laser_slam_tpu_torch.nav import local_planner as tlp
from laser_slam_tpu_torch.nav import planner as tpl
from laser_slam_tpu_torch.nav import trajectory as ttr
from laser_slam_tpu_torch.nav.trajectory import CMD_SLICE, MAX_ACC, MAX_DEC, MAX_SPD
from laser_slam_tpu_torch.ops import preprocess as tpp

from tests.conftest import box_room_ranges

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
CPU = "cpu"
ATOL = 1e-5
T = lambda x: torch.tensor(np.asarray(x))      # noqa: E731  (a copy, as a tensor)


def tscan(ranges):
    """The port's preprocessed scan ``[N]`` of ranges ``[N]``, on the CPU."""
    s = tpp.preprocess(torch.tensor(np.asarray(ranges, np.float32))[None], TMODEL)
    return type(s)(*(x[0] for x in s))


def jscan_(ranges):
    return jax.tree.map(lambda a: a[0], jpp.preprocess(jnp.asarray(ranges, jnp.float32)[None],
                                                       MODEL))


def grids(lo, spec_fields):
    """The same log-odds grid in both packages."""
    jg = jocc.OccupancyGrid(jnp.asarray(lo, jnp.float32), jocc.GridSpec2D(**spec_fields))
    return jg, interop.grid_from_numpy(lo, spec_fields)


def same(got, want):
    """Every field of a port NamedTuple equals the JAX one bit for bit."""
    g = interop.named_state_to_numpy(got)
    for k, v in want._asdict().items():
        np.testing.assert_array_equal(g[k], np.asarray(v), err_msg=k)


def close(got, want, atol=ATOL):
    g = interop.named_state_to_numpy(got)
    for k, v in want._asdict().items():
        np.testing.assert_allclose(g[k], np.asarray(v), atol=atol, rtol=0, err_msg=k)


def room_scans(n=20, seed=0):
    """``n`` noisy box-room scans from moving poses (numpy seed). The
    first lies on the 0.1 m grid lines with heading 0, where three beams
    run along cell edges: their end points and samples fall in the cell
    the last bit of the reference's bearing, sine and cosine decides."""
    rng = np.random.default_rng(seed)
    poses = np.asarray([(0.3 * i * np.cos(0.1 * i) - 1.0, 0.2 * i - 2.0, 0.15 * i)
                        for i in range(n)], np.float32)
    r = np.stack([box_room_ranges(MODEL, p) for p in poses])
    return poses, (r + rng.normal(0, 0.01, r.shape)).astype(np.float32)


# -- test_nav.py ---------------------------------------------------------------

WALL_SPEC = dict(origin_x=0.0, origin_y=0.0, resolution=0.1, width=100, height=100)


def wall_grid(gap=True):
    """10x10m grid with a wall across the middle (leaving a gap)."""
    lo = np.full((100, 100), -1.0, np.float32)  # known free
    lo[50, :80 if gap else 100] = 5.0
    return lo


def test_wavefront_goes_around_wall():
    _, g = grids(wall_grid(), WALL_SPEC)
    res = tpl.plan_path(g, torch.tensor([2.0, 2.0]), torch.tensor([2.0, 8.0]), robot_radius=0.15)
    assert bool(res.reached)
    path = res.path.numpy()[: int(res.n_valid)]
    assert path[:, 0].max() > 7.5        # detours through the gap on the right
    assert float(res.length) > 10.0      # straight-line distance is 6


def test_plan_fails_when_blocked():
    lo = np.full((60, 60), -1.0, np.float32)
    lo[30, :] = 5.0  # full wall, no gap
    _, g = grids(lo, dict(origin_x=0.0, origin_y=0.0, resolution=0.1, width=60, height=60))
    res = tpl.plan_path(g, torch.tensor([1.0, 1.0]), torch.tensor([1.0, 5.0]), robot_radius=0.15)
    assert not bool(res.reached)


def test_inflation_thickens_walls():
    jg, g = grids(wall_grid(), WALL_SPEC)
    inflated = tpl.inflate_obstacles(g, robot_radius=0.3).numpy()
    assert inflated[48, 40] and inflated[52, 40]  # 2 cells above/below wall
    assert not inflated[40, 40]
    for radius in (0.05, 0.15, 0.3, 0.55):
        np.testing.assert_array_equal(tpl.inflate_obstacles(g, radius).numpy(),
                                      np.asarray(jpl.inflate_obstacles(jg, radius)))


def test_security_zones():
    r = np.full(MODEL.n_beams, 10.0, np.float32)
    v, zone = tctl.security_speed_cap(TMODEL, tscan(r))
    assert float(v) == 1.0 and int(zone) == -1
    r2 = r.copy()
    mid = MODEL.n_beams // 2
    r2[mid - 3: mid + 4] = 0.5  # wide enough to survive the median filter
    v2, zone2 = tctl.security_speed_cap(TMODEL, tscan(r2))
    assert float(v2) <= 0.11 and int(zone2) in (0, 1)
    r3 = r.copy()
    r3[:7] = 0.5
    v3, _ = tctl.security_speed_cap(TMODEL, tscan(r3))
    assert float(v3) == 1.0


def test_pure_pursuit_steers_toward_path():
    path = [[1.0, 0.0], [2.0, 0.0], [3.0, 1.0], [4.0, 2.0]]
    v, omega = tctl.pure_pursuit(torch.tensor([0.0, 0.0, np.pi / 2]), torch.tensor(path), 4)
    assert float(omega) < -0.5       # path to the right → negative omega
    v2, omega2 = tctl.pure_pursuit(torch.tensor([0.5, 0.0, 0.0]), torch.tensor(path), 4)
    assert float(v2) > 0.5
    assert abs(float(omega2)) < 1.0
    # Against JAX on seeded poses and paths, past the end and mid-path.
    rng = np.random.default_rng(3)
    for _ in range(20):
        p = rng.uniform(-3, 3, (12, 2)).astype(np.float32)
        pose = rng.uniform(-2, 2, 3).astype(np.float32)
        n = int(rng.integers(1, 13))
        want = jax.jit(jctl.pure_pursuit)(jnp.asarray(pose), jnp.asarray(p), jnp.asarray(n))
        got = tctl.pure_pursuit(T(pose), T(p), n)
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], atol=ATOL)


def test_track_step_combines():
    path = torch.tensor([[1.0, 0.0], [3.0, 0.0]])
    r = np.full(MODEL.n_beams, 10.0, np.float32)
    mid = MODEL.n_beams // 2
    r[mid - 3: mid + 4] = 0.4  # obstacle ahead
    cmd = tctl.track_step(TMODEL, tscan(r), torch.zeros(3), path, 2)
    assert float(cmd.v) <= 0.11  # capped by zone
    want = jax.jit(lambda s: jctl.track_step(MODEL, s, jnp.zeros(3), jnp.asarray(path.numpy()),
                                             jnp.asarray(2)))(jscan_(r))
    close(cmd, want)


# -- plan_path and wavefront against JAX -----------------------------------------

def test_wavefront_matches_jax():
    rng = np.random.default_rng(0)
    obstacles = rng.random((70, 90)) < 0.25
    goal = np.asarray([17, 41], np.int32)
    want = jax.jit(lambda o, g: jpl.wavefront(o, g, 0.05, 160))(jnp.asarray(obstacles),
                                                               jnp.asarray(goal))
    got = tpl.wavefront(T(obstacles), T(goal), 0.05, 160)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# Cell-edge coordinates: ``x / 0.1`` truncates one cell lower than
# ``x · (1/0.1)``, which is what the compiled reference computes.
EDGE = float(np.nextafter(np.float32(1.7), np.float32(0.0)))


@pytest.mark.parametrize("case", ["free", "wall", "blocked", "edge", "edge_origin"])
def test_plan_path_matches_jax(case):
    """Plans of the compiled reference and of the port: identical cells,
    ``n_valid`` and ``reached``; on a grid with a nonzero origin the path
    points are the reference's fused multiply-adds."""
    spec = dict(WALL_SPEC)
    start, goal, lo = (2.0, 2.0), (2.0, 8.0), wall_grid()
    if case == "free":
        lo = np.full((100, 100), -1.0, np.float32)
        start, goal = (0.7, 9.3), (9.1, 0.4)
    elif case == "blocked":
        lo = wall_grid(gap=False)
    elif case == "edge":
        start, goal = (EDGE, 2.0), (2.0, EDGE + 6.0)
        assert int(np.float32(EDGE) / np.float32(0.1)) == 16
        assert int(np.float32(EDGE) * (np.float32(1) / np.float32(0.1))) == 17
    elif case == "edge_origin":
        spec.update(origin_x=-3.3, origin_y=1.1)
        start, goal = (EDGE - 3.3, 3.1), (-1.3, EDGE + 7.1)
    jg, g = grids(lo, spec)
    f = jax.jit(lambda g_, a, b: jpl.plan_path(g_, a, b, robot_radius=0.15))
    want = f(jg, jnp.asarray(start, jnp.float32), jnp.asarray(goal, jnp.float32))
    got = tpl.plan_path(g, torch.tensor(start), torch.tensor(goal), robot_radius=0.15)
    assert bool(got.reached) == (case != "blocked")
    for k in ("path", "n_valid", "reached"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    np.testing.assert_allclose(float(got.length), float(want.length), rtol=ATOL)


# -- test_local_map.py -------------------------------------------------------------

def wall_scan(dist=2.0):
    """Scan of a straight wall ``dist`` m ahead (x = dist plane)."""
    fi = np.arange(MODEL.n_beams) * MODEL.dfi + MODEL.fi_min
    r = np.where(np.abs(fi) < 1.0, dist / np.maximum(np.cos(fi), 1e-3), MODEL.max_range + 1)
    return r.astype(np.float32)


def test_update_marks_wall_and_freespace():
    lmap = tlm.empty_local_map(size=96, resolution=0.1, device=CPU)
    scan = tscan(wall_scan(2.0))
    for _ in range(4):
        lmap = tlm.update_local_map(lmap, TMODEL, scan, torch.zeros(3))
    prob = lmap.probability().numpy()
    cy, cx = 48, 48
    assert prob[cy, cx + 20] > 0.7, prob[cy, cx + 18: cx + 24]
    assert prob[cy, cx + 10] < 0.2                      # free space on the way
    assert abs(prob[cy, cx - 20] - 0.5) < 0.05          # behind the robot: unknown


def test_recenter_preserves_world_content():
    lmap = tlm.empty_local_map(size=96, resolution=0.1, device=CPU)
    lmap = tlm.update_local_map(lmap, TMODEL, tscan(wall_scan(2.0)), torch.zeros(3))
    before = lmap.log_odds.numpy()
    cy, cx = 48, 48
    assert before[cy, cx + 20] > 0
    moved = tlm.recenter(lmap, torch.tensor([1.0, 0.0, 0.0]))
    after = moved.log_odds.numpy()
    assert np.allclose(after[cy, cx + 10], before[cy, cx + 20])
    assert np.allclose(after[:, -5:], 0.0)              # revealed strip is unknown
    # Against JAX, both ways and past the window.
    jm = jlm.LocalMap(jnp.asarray(before), jnp.asarray(lmap.origin_cell.numpy()), 0.1)
    for pose in ([1.0, 0.0, 0.0], [-0.73, 2.31, 1.0], [-20.0, 3.0, 0.0], [EDGE, -EDGE, 0.0]):
        want = jax.jit(jlm.recenter)(jm, jnp.asarray(pose, jnp.float32))
        got = tlm.recenter(lmap, torch.tensor(pose))
        np.testing.assert_array_equal(got.log_odds.numpy(), np.asarray(want.log_odds))
        np.testing.assert_array_equal(got.origin_cell.numpy(), np.asarray(want.origin_cell))


def test_recenter_same_pose_is_identity():
    lmap = tlm.empty_local_map(size=32, resolution=0.1, device=CPU)
    lo = lmap.log_odds.clone()
    lo[10, 12] = 3.0
    lmap = lmap._replace(log_odds=lo)
    out = tlm.recenter(lmap, torch.tensor([0.05, 0.05, 0.3]))
    assert torch.equal(out.log_odds, lmap.log_odds)


def test_distance_field_exact_euclidean():
    lmap = tlm.empty_local_map(size=48, resolution=0.5, device=CPU)
    occ_at = [(10, 20), (30, 5), (40, 40)]
    lo = lmap.log_odds.clone()
    for y, x in occ_at:
        lo[y, x] = 5.0
    lmap = lmap._replace(log_odds=lo)
    d = tlm.obstacle_distance_field(lmap).numpy()
    yy, xx = np.mgrid[0:48, 0:48]
    brute = np.full((48, 48), np.inf)
    for y, x in occ_at:
        brute = np.minimum(brute, np.hypot(yy - y, xx - x))
    assert np.allclose(d, brute * 0.5, atol=1e-3)


def test_service_stream():
    svc = tlm.LocalMapService(TMODEL, size=64, resolution=0.1, device=CPU)
    scan = tscan(wall_scan(1.5))
    for i in range(3):
        svc.stream_in(scan, np.asarray([0.1 * i, 0.0, 0.0], np.float32))
    d = svc.distance_field().numpy()
    assert 0.8 < d[32, 32] < 1.6, d[32, 32]
    assert svc.map.log_odds.device.type == "cpu"


def test_update_local_map_matches_jax():
    """20 scans from moving poses through the compiled reference's update
    (``LocalMapService``'s) and the port's: log-odds 1e-5 (the same
    samples in the same cells; float sums of the free-space weights),
    ``origin_cell`` equal; then the distance field 1e-5."""
    poses, ranges = room_scans(20)
    jsvc = jlm.LocalMapService(MODEL, size=128, resolution=0.1)
    tsvc = tlm.LocalMapService(TMODEL, size=128, resolution=0.1, device=CPU)
    for p, r in zip(poses, ranges):
        jsvc.stream_in(jscan_(r), p)
        tsvc.stream_in(tscan(r), p)
        lo, origin, _ = interop.local_map_to_numpy(tsvc.map)
        np.testing.assert_array_equal(origin, np.asarray(jsvc.map.origin_cell))
        np.testing.assert_allclose(lo, np.asarray(jsvc.map.log_odds), atol=ATOL, rtol=0)
    assert (lo > 1.0).sum() > 100 and (lo < -1.0).sum() > 1000
    np.testing.assert_allclose(tsvc.distance_field().numpy(),
                               np.asarray(jlm.obstacle_distance_field(jsvc.map)), atol=ATOL)
    # A map carried across packages continues there.
    back = interop.local_map_from_numpy(np.asarray(jsvc.map.log_odds),
                                        np.asarray(jsvc.map.origin_cell), 0.1)
    assert back.origin_cell.dtype == torch.int32
    np.testing.assert_allclose(back.log_odds.numpy(), lo, atol=ATOL)


# -- test_local_planner.py ---------------------------------------------------------

def test_seed_grow_respects_walls():
    obstacle = np.zeros((tlp.VIEW_H, tlp.VIEW_W), bool)
    obstacle[10, :] = True          # full wall at row 10
    reach = tlp.seed_grow(T(obstacle)).numpy()
    assert reach[5, 10] and not reach[20, 10]
    obstacle[10, 15] = False        # a gap opens the far side
    reach = tlp.seed_grow(T(obstacle)).numpy()
    assert reach[20, 10]
    rng = np.random.default_rng(1)
    for _ in range(5):
        ob = rng.random((tlp.VIEW_H, tlp.VIEW_W)) < 0.3
        ob[0, tlp.VIEW_W // 2] = False
        np.testing.assert_array_equal(tlp.seed_grow(T(ob)).numpy(),
                                      np.asarray(jax.jit(jlp.seed_grow)(jnp.asarray(ob))))


def test_erosion_shrinks_corridor():
    reach = np.zeros((tlp.VIEW_H, tlp.VIEW_W), bool)
    reach[:, 8:13] = True           # 5-cell corridor
    trav = tlp.erode_by_robot(T(reach), robot_cells=2).numpy()
    assert trav[:, 10].any() and not trav[:, 8].any() and not trav[:, 12].any()
    rng = np.random.default_rng(2)
    for cells in (0, 1, 2, 3):
        r = rng.random((tlp.VIEW_H, tlp.VIEW_W)) < 0.8
        np.testing.assert_array_equal(
            tlp.erode_by_robot(T(r), cells).numpy(),
            np.asarray(jax.jit(jlp.erode_by_robot, static_argnums=1)(jnp.asarray(r), cells)))


def test_milestone_straight_corridor():
    trav = np.zeros((tlp.VIEW_H, tlp.VIEW_W), bool)
    trav[:40, 8:13] = True
    ms = tlp.milestone_select(T(trav))
    assert bool(ms.ok)
    r, c = ms.milestone_rc.numpy()
    assert r >= 35 and 8 <= c <= 13
    path = ms.path_xy.numpy()
    assert path.shape == (4, 2) and path[-1, 0] > path[0, 0]


def test_milestone_dodges_offset_gap():
    """Wall ahead with a gap on the right: the line target steers into the
    gap; the Milestone is the compiled reference's bit for bit."""
    trav = np.zeros((tlp.VIEW_H, tlp.VIEW_W), bool)
    trav[:20, :] = True             # open near field
    trav[20:23, :] = False          # wall band...
    trav[20:23, 15:19] = True       # ...with a gap at columns 15-18
    trav[23:40, 14:20] = True       # free space beyond the gap
    ms = tlp.milestone_select(T(trav))
    assert bool(ms.ok)
    r, c = ms.milestone_rc.numpy()
    assert r >= 30 and c >= 14
    same(ms, jax.jit(jlp.milestone_select)(jnp.asarray(trav)))
    for shift in range(-4, 1):      # the gap moved to the other side
        t2 = np.roll(trav, shift - 9, axis=1)
        same(tlp.milestone_select(T(t2)), jax.jit(jlp.milestone_select)(jnp.asarray(t2)))


def test_dodge_path_end_to_end():
    """Full chain on a synthetic scan: open 4 m corridor ahead."""
    n = MODEL.n_beams
    fi = np.radians(MODEL.fi_min_deg) + np.arange(n) * np.radians(MODEL.fov_deg / (n - 1))
    with np.errstate(divide="ignore"):
        r_wall = np.where(np.abs(np.sin(fi)) > 1e-6, 1.0 / np.abs(np.sin(fi)), MODEL.max_range)
    ranges = np.minimum(r_wall, MODEL.max_range - 1.0).astype(np.float32)
    ms = tlp.dodge_path(TMODEL, tscan(ranges))
    assert bool(ms.ok)
    path = ms.path_xy.numpy()
    assert np.all(np.abs(path[:, 1]) < 1.0) and path[-1, 0] > 2.0
    same(ms, jax.jit(lambda s: jlp.dodge_path(MODEL, s))(jscan_(ranges)))


def test_dodge_path_matches_jax():
    """The compiled reference's dodge and the port's on 40 seeded scans
    from moving poses: the instant view, the Milestone, bit for bit (the
    bearings, sines and cosines of :mod:`refmath`)."""
    poses, ranges = room_scans(40, seed=4)
    f = jax.jit(lambda s: jlp.dodge_path(MODEL, s))
    g = jax.jit(lambda s: jlp.instant_view(MODEL, s))
    oks = 0
    for r in ranges:
        np.testing.assert_array_equal(tlp.instant_view(TMODEL, tscan(r)).numpy(),
                                      np.asarray(g(jscan_(r))))
        ms = tlp.dodge_path(TMODEL, tscan(r))
        same(ms, f(jscan_(r)))
        oks += bool(ms.ok)
    assert oks >= 20


@pytest.mark.parametrize("n", [40, 50, 64, 100, 200])
def test_linspace_matches_jax(n):
    """``jnp.linspace(0, 1, n)`` bit for bit at the sizes the code uses
    (``milestone_select``: 2·VIEW_H; ``blend_corner``: 40, 50, 100, 200)."""
    np.testing.assert_array_equal(refmath.linspace01(n).numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)))


def test_refmath_matches_the_reference():
    """``sincos`` and ``fma`` against the reference's compiled float32 on
    seeded angles and products."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-7, 7, 20000), rng.uniform(-0.6, 0.6, 2000),
                        np.float32(np.pi / 2) * np.arange(-8, 9)]).astype(np.float32)
    s, c = refmath.sincos(T(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jax.jit(jnp.sin)(jnp.asarray(x))))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jax.jit(jnp.cos)(jnp.asarray(x))))
    a, b = x[:5000], x[5000:10000]
    np.testing.assert_array_equal(refmath.fma(T(a), T(b), 0.3).numpy(),
                                  np.asarray(jax.jit(lambda u, v: u * v + 0.3)(a, b)))
    # The bearings inside a fusion: their sines.
    np.testing.assert_array_equal(refmath.sincos(refmath.bearings(TMODEL))[0].numpy(), np.asarray(
        jax.jit(lambda r: jnp.sin(MODEL.bearings(jnp.float32)) * r)(jnp.ones(181))))


# -- test_trajectory.py ------------------------------------------------------------

def check_profile(p, dist, v0, tol=0.08):
    v = p.v.numpy()[p.valid.numpy()]
    dv = np.diff(np.concatenate([[v0], v]))
    assert dv.max() <= MAX_ACC * CMD_SLICE + 1e-5
    assert dv.min() >= -MAX_DEC * CMD_SLICE - 1e-5
    assert v.max() <= MAX_SPD + 1e-5
    s = v.sum() * CMD_SLICE
    assert abs(s - dist) < max(tol, 0.05 * dist), (s, dist)


def test_trapezoid_reaches_cruise_and_stops():
    p = ttr.trapezoid_profile(5.0, 0.0, 0.0, device=CPU)
    check_profile(p, 5.0, 0.0)
    v = p.v.numpy()[p.valid.numpy()]
    assert abs(v.max() - MAX_SPD) < 1e-3 and v[-1] < 0.05


def test_trapezoid_triangle_on_short_segment():
    p = ttr.trapezoid_profile(0.4, 0.0, 0.0, device=CPU)
    check_profile(p, 0.4, 0.0)
    assert p.v.numpy()[p.valid.numpy()].max() < MAX_SPD - 0.05


def test_trapezoid_clamps_unreachable_end_speed():
    p = ttr.trapezoid_profile(0.2, 0.0, MAX_SPD, device=CPU)
    assert abs(float(p.v_end) - np.sqrt(2 * MAX_ACC * 0.2)) < 1e-3
    check_profile(p, 0.2, 0.0)


def test_spin_profile_turns_the_angle():
    for ang in (np.pi / 2, -np.pi):
        p = ttr.spin_profile(ang, device=CPU)
        w = p.v.numpy()[p.valid.numpy()]
        assert abs(w.sum() * CMD_SLICE - ang) < 0.05
        assert np.all(np.sign(w) == np.sign(ang))


def test_wheel_velocities():
    vl, vr = ttr.wheel_velocities(0.5, 0.2, wheel_base=0.5)
    assert abs(float(vl) - 0.45) < 1e-6 and abs(float(vr) - 0.55) < 1e-6
    vl, vr = ttr.wheel_velocities(torch.tensor([0.5, 0.1]), torch.tensor([0.2, -1.0]), 0.5)
    wl, wr = jtr.wheel_velocities(jnp.asarray([0.5, 0.1]), jnp.asarray([0.2, -1.0]), 0.5)
    np.testing.assert_array_equal(vl.numpy(), np.asarray(wl))
    np.testing.assert_array_equal(vr.numpy(), np.asarray(wr))


def test_schedule_slows_for_corners_and_stops():
    path = [(0.0, 0.0), (4.0, 0.0), (4.0, 4.0)]
    sched = ttr.plan_velocity_schedule(path, device=CPU)
    ok = sched.seg_ok.numpy()
    assert ok[:2].all() and not ok[2:].any()
    v0 = sched.v[0].numpy()[sched.valid[0].numpy()]
    v1 = sched.v[1].numpy()[sched.valid[1].numpy()]
    assert v0[-1] < 0.6 * MAX_SPD
    assert abs(v0[-1] - v1[0]) < MAX_ACC * CMD_SLICE + 0.06
    assert v1[-1] < 0.05
    assert abs(v0.sum() * CMD_SLICE - 4.0) < 0.2 and abs(v1.sum() * CMD_SLICE - 4.0) < 0.2


def test_trajectory_functions_match_jax():
    """Every output of the trajectory functions against JAX: 1e-5."""
    rng = np.random.default_rng(6)
    for dist, v0, ve in [(5.0, 0.0, 0.0), (0.4, 0.0, 0.0), (0.2, 0.0, MAX_SPD),
                         *rng.uniform(0, [6, 0.7, 0.7], (8, 3))]:
        close(ttr.trapezoid_profile(float(dist), float(v0), float(ve), device=CPU),
              jtr.trapezoid_profile(float(dist), float(v0), float(ve)))
    for ang in (np.pi / 2, -np.pi, 0.05, *rng.uniform(-4, 4, 5)):
        close(ttr.spin_profile(float(ang), device=CPU), jtr.spin_profile(float(ang)))
    corners = rng.uniform(-3, 3, (6, 3, 2)).astype(np.float32)
    corners[0] = [[0, 0], [2, 0], [2, 2]]
    corners[1] = [[0, 0], [2, 0], [0, 0.01]]          # a U-turn: not blendable
    for n in (50, 100, 200):
        got = ttr.blend_corner(*(T(corners[:, k]) for k in range(3)), n_slices=n)
        for i, c in enumerate(corners):
            want = jtr.blend_corner(*(jnp.asarray(p) for p in c), n_slices=n)
            assert bool(got.ok[i]) == bool(want.ok)
            np.testing.assert_allclose(got.xy[i].numpy(), np.asarray(want.xy), atol=ATOL)
    path = np.array([[0, 0], [2, 0], [2, 2], [4, 2], [4.2, 5.0]], np.float32)
    for n in (40, 100):
        np.testing.assert_allclose(ttr.blend_path(path, n, device=CPU), jtr.blend_path(path, n),
                                   atol=ATOL)
    smooth = jtr.blend_path(path)
    close(ttr.wheel_schedule_along(smooth, wheel_base=0.5, device=CPU),
          jtr.wheel_schedule_along(smooth, wheel_base=0.5))
    limits = np.asarray([0.7, 0.3, 0.5, 0.6], np.float32)
    close(ttr.plan_velocity_schedule(path, limits, device=CPU),
          jtr.plan_velocity_schedule(path, limits))


def test_trajectory_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.trapezoid_profile(1.0, 0.0, 0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.LocalMapService(TMODEL)
    assert ttr.trapezoid_profile(torch.tensor(1.0), 0.0, 0.0).v.device.type == "cpu"
