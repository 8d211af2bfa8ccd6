"""The fused PSM CUDA kernel (K1) against its plain PyTorch versions on the
card: the batch entry against ``psm.match_psm``, its error-index epilogue
against ``psm.error_index``, the keyframe-chain entry against the step loop
of ``odometry.odometry_keyframe``. The sparse correlative score-volume
kernel against the grouped conv of its plain version. The beam model's
ray-march kernel against the dense ladder of its plain version, and the
ray-cast + ICP update on the card against the CPU and, at the cell's
shape, under a trace; global relocalization's sampler and scoring
against the benchmark's reference at the relocalization cell's shape. The
point-ICP nearest-two search kernel against the
plain ``[B, N, M]`` block, and ``match_icp_points`` with it against the
benchmark's frozen copy. Then the
loop-closure backend on the card: the chunk verifier against the same call
on the CPU, and ``cli slam`` twice on a short log. Then the later paths on the card: the online
session, localization, the ICP matchers, the loopback, the robot path,
the landmark filters against the CPU with the same draws, and
``parallel/`` on a one-rank NCCL group. The particle filter's phases as
captured CUDA graphs against their eager bodies. These tests need a CUDA device and skip
without one; they import no jax, so that they run where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from laser_slam_tpu_torch import cli
from laser_slam_tpu_torch.core import scan as S
from laser_slam_tpu_torch.core import se2
from laser_slam_tpu_torch.graph import loop_closure, submap
from laser_slam_tpu_torch.localization import raycast
from laser_slam_tpu_torch.ops import correlative, icp_points, odometry
from laser_slam_tpu_torch.ops import preprocess as pp
from laser_slam_tpu_torch.ops import psm
from laser_slam_tpu_torch.ops.cuda import (
    correlative_kernel,
    icp_nearest_kernel,
    psm_kernel,
    raycast_kernel,
)
from laser_slam_tpu_torch.utils import cuda_graphs
from laser_slam_tpu_torch.utils.profiling import profiler

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import synthetic_log  # noqa: E402
import beam_cell as cell  # noqa: E402
import icp_search_cases as icp_cases  # noqa: E402

POSE_ATOL = 1e-4    # float32 op order (fused multiply-adds, block reductions)
ERR_RTOL = 1e-4
# Chain entry against the step loop: both run the kernel's one arithmetic for
# the matches and error indices; only the pose composition differs (ATen's
# separate kernels against the chain kernel's registers), which is float32
# round-off carried along the chain. 1e-3 m / rad leaves that three orders of
# magnitude of room and is far below a flipped keyframe decision (> 1 cm).
CHAIN_ATOL = 1e-3

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def pairs(model, n, seed, dev):
    """``n`` pairs in the asymmetric test room, preprocessed on ``dev``."""
    rng = np.random.default_rng(seed)
    p0 = np.stack([rng.uniform(-1.0, 2.5, n), rng.uniform(-1.5, 2.0, n),
                   rng.uniform(-np.pi, np.pi, n)], 1)
    rel = np.stack([rng.normal(0, 0.06, n), rng.normal(0, 0.06, n), rng.normal(0, 0.05, n)], 1)
    fi = model.bearings(torch.float64).numpy()
    out = []
    for p in (p0, se2.np_compose(p0, rel)):
        r = synthetic_log.ray_cast(synthetic_log.room_walls(), p, fi, model.max_range)
        r = np.where(r <= model.max_range, r + rng.normal(0, 0.01, r.shape), r)
        out.append(pp.preprocess(torch.as_tensor(r, dtype=torch.float32, device=dev), model))
    return out[0], out[1], rel


@pytest.mark.parametrize("batch", [1, 2, 64])
@pytest.mark.parametrize("name", ["LMS211", "LMS511", "LMS151"])
def test_fused_kernel_matches_plain(cuda, name, batch):
    model = S.PRESETS[name]
    ref, cur, rel = pairs(model, batch, 24, cuda)
    init = torch.as_tensor(rel * 0.5, dtype=torch.float32, device=cuda)
    before = psm_kernel.match_psm_fused.launches
    k = psm_kernel.match_psm_fused(model, ref, cur, init)
    p = psm.match_psm(model, ref, cur, init)
    torch.cuda.synchronize()
    assert psm_kernel.match_psm_fused.launches == before + 1
    np.testing.assert_array_equal(k.fail.cpu().numpy(), p.fail.cpu().numpy())
    np.testing.assert_allclose(k.pose.cpu().numpy(), p.pose.cpu().numpy(), atol=POSE_ATOL)
    np.testing.assert_allclose(k.err.cpu().numpy(), p.err.cpu().numpy(), rtol=ERR_RTOL)


def test_fused_kernel_rejects_what_it_does_not_take(cuda):
    model = S.LMS211
    ref, cur, _ = pairs(model, 4, 25, cuda)
    before = psm_kernel.match_psm_fused.launches
    with pytest.raises(ValueError):    # float64 ranges
        psm_kernel.match_psm_fused(model, ref._replace(ranges=ref.ranges.double()), cur)
    with pytest.raises(ValueError):    # a beam count the model does not have
        psm_kernel.match_psm_fused(S.LMS511, ref, cur)
    with pytest.raises(ValueError):    # inputs on two devices
        psm_kernel.match_psm_fused(model, ref.to("cpu"), cur)
    assert psm_kernel.match_psm_fused.launches == before


@pytest.mark.parametrize("batch", [1, 2, 64])
@pytest.mark.parametrize("name", ["LMS211", "LMS511", "LMS151"])
def test_error_index_epilogue_matches_plain(cuda, name, batch):
    """The epilogue against ``psm.error_index`` at the kernel's own pose;
    the error reference is another scan than the match reference, as in the
    keyframe step. rtol 1e-4: the sums run in another order."""
    model = S.PRESETS[name]
    ref, cur, rel = pairs(model, batch, 26, cuda)
    other = S.Scan(*(torch.roll(x, 1, dims=0) for x in ref)) if batch > 1 else cur
    init = torch.as_tensor(rel * 0.5, dtype=torch.float32, device=cuda)
    before = psm_kernel.match_psm_fused.launches
    k, (ex, ey, en) = psm_kernel.match_psm_fused(model, ref, cur, init, error_ref=other)
    torch.cuda.synchronize()
    assert psm_kernel.match_psm_fused.launches == before + 1
    alone = psm_kernel.match_psm_fused(model, ref, cur, init)
    for a, b in zip(k, alone):     # the epilogue leaves the match as it is
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    px, py, pn = psm.error_index(model, other, cur, k.pose)
    np.testing.assert_array_equal(en.cpu().numpy(), pn.cpu().numpy())
    np.testing.assert_allclose(ex.cpu().numpy(), px.cpu().numpy(), rtol=ERR_RTOL)
    np.testing.assert_allclose(ey.cpu().numpy(), py.cpu().numpy(), rtol=ERR_RTOL)
    assert (en > 0).any()
    # No overlapping beam reads as the worst error.
    far = torch.tensor([[30.0, 30.0, 0.0]] * batch, device=cuda)
    ident = S.Scan(cur.ranges, torch.ones_like(cur.bad), cur.seg)   # an all-bad reference
    _, (fx, fy, fn) = psm_kernel.match_psm_fused(model, ident, cur, far, error_ref=ident)
    assert (fn == 0).all() and (fx == 1e6).all() and (fy == 1e6).all()


def synthetic_scans(model, n_scans, dev, blind=()):
    """The synthetic log's trajectory (three whips behind dt gaps, so some
    steps switch keyframes and some fail) ray-cast at ``model``'s beams;
    the scans listed in ``blind`` see nothing (every beam out of range), so
    both of their matches fail and the chain drops them."""
    rng = np.random.default_rng(5)
    gt, ts = synthetic_log.trajectory(n_scans)
    r = synthetic_log.ray_cast(synthetic_log.floor_plan(), gt,
                               model.bearings(torch.float64).numpy())
    r = np.where(r <= synthetic_log.MAX_RANGE, r + rng.normal(0.0, synthetic_log.NOISE, r.shape), r)
    r[list(blind)] = model.max_range + 1.0
    return pp.preprocess(torch.as_tensor(r.astype(np.float32), device=dev), model), ts


@pytest.mark.parametrize("name,n_scans", [("LMS211", 300), ("LMS511", 120), ("LMS151", 120)])
def test_chain_entry_matches_step_loop(cuda, name, n_scans):
    model = S.PRESETS[name]
    blind = (40, 41, 90)
    scans, ts = synthetic_scans(model, n_scans, cuda, blind)
    chain_before = psm_kernel.odometry_chain_fused.launches
    match_before = psm_kernel.match_psm_fused.launches
    got = psm_kernel.odometry_chain_fused(
        model, scans, odometry.KEYFRAME_ERR_THRESH, 2.0 * odometry.KEYFRAME_ERR_THRESH)
    torch.cuda.synchronize()
    assert psm_kernel.odometry_chain_fused.launches == chain_before + 1
    assert psm_kernel.match_psm_fused.launches == match_before
    want = odometry._chain_steps(model, scans)
    assert psm_kernel.match_psm_fused.launches == match_before + n_scans - 1
    for g, w in zip(got[1:], want[1:]):        # switched, discarded, deep flag
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), atol=CHAIN_ATOL)
    assert got[1].any()                        # keyframes were switched
    # Blind scans are discarded (step i-1 is scan i), and the scan after one
    # is matched against the last scan that was kept.
    assert got[2].cpu().numpy()[[b - 1 for b in blind]].all()
    np.testing.assert_array_equal(got[0][39].cpu().numpy(), got[0][40].cpu().numpy())
    iters = psm_kernel.odometry_chain_fused.last_iters.cpu().numpy()
    assert iters.shape == (n_scans - 1, 2) and (iters >= 1).all() and (iters <= 15).all()

    # The whole of odometry_keyframe by both routes, pass 2 included.
    a = odometry.odometry_keyframe(model, scans, deep_chunk=8, timestamps=ts)
    b = odometry.odometry_keyframe(model, scans, deep_chunk=8, timestamps=ts, chain="steps")
    for f in ("switched", "discarded", "weak", "fracture", "rematched"):
        np.testing.assert_array_equal(getattr(a, f).cpu().numpy(), getattr(b, f).cpu().numpy())
    np.testing.assert_allclose(a.poses.cpu().numpy(), b.poses.cpu().numpy(), atol=CHAIN_ATOL)


def test_chain_entry_edge_cases(cuda):
    model = S.LMS211
    scans, _ = synthetic_scans(model, 3, cuda)
    one = S.Scan(*(x[:1] for x in scans))
    before = psm_kernel.odometry_chain_fused.launches
    poses, sw, disc, deep = psm_kernel.odometry_chain_fused(model, one, 0.05, 0.10)
    assert poses.shape == (0, 3) and sw.shape == disc.shape == deep.shape == (0,)
    assert psm_kernel.odometry_chain_fused.launches == before    # nothing to launch
    two = S.Scan(*(x[:2] for x in scans))
    got = psm_kernel.odometry_chain_fused(model, two, 0.05, 0.10)
    want = odometry._chain_steps(model, two)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), atol=CHAIN_ATOL)
    with pytest.raises(ValueError):    # a beam count the model does not have
        psm_kernel.odometry_chain_fused(S.LMS511, scans, 0.05, 0.10)
    with pytest.raises(ValueError):    # CPU tensors: the plain version is the step loop
        psm_kernel.odometry_chain_fused(model, scans.to("cpu"), 0.05, 0.10)


def test_chain_kernel_is_credited_to_the_odometry_chain_span(cuda):
    """Under a ``torch.profiler`` window K1's chain entry launches inside its
    dispatcher operator, so the profiler credits ``psm_chain_kernel``'s
    device time to the program's ``odometry.chain`` span around the call;
    the window changes no pose."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = S.LMS211
    scans, ts = synthetic_scans(model, 300, cuda, blind=(40, 41, 90))
    plain = odometry.odometry_keyframe(model, scans, deep_chunk=8, timestamps=ts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = odometry.odometry_keyframe(model, scans, deep_chunk=8, timestamps=ts)
        torch.cuda.synchronize()
    assert torch.equal(traced.poses, plain.poses)

    def kernels(event):
        yield from event.kernels
        for child in event.cpu_children:
            yield from kernels(child)

    chain = [e for e in prof.events()
             if e.name == "odometry.chain" and e.device_type == DeviceType.CPU]
    assert len(chain) == 1
    k1 = [k for k in kernels(chain[0]) if "psm_chain_kernel" in k.name]
    assert len(k1) == 1 and k1[0].duration > 0
    assert chain[0].device_time_total >= k1[0].duration


# -- the sparse correlative score-volume kernel ---------------------------------

def _volume_pair(planes, pts, ok, thetas, base, res, half_extent, n_steps):
    """The sparse kernel's sums and the plain version's (the grouped
    depthwise conv) from the same rotated cells."""
    g = planes.shape[-1]
    ix, iy, inb = correlative._rotated_cells(pts, ok, thetas, base, res, half_extent, g)
    cells = torch.where(inb, iy * g + ix, -1).to(torch.int32)
    before = correlative_kernel.score_volume_sparse.launches
    got = correlative_kernel.score_volume_sparse(planes, cells, n_steps)
    want = correlative._score_volume_conv(planes, ix, iy, inb, n_steps)
    torch.cuda.synchronize()
    assert correlative_kernel.score_volume_sparse.launches == before + 1
    return got, want, inb


@pytest.mark.parametrize("name", ["LMS211", "LMS511"])
def test_sparse_volume_is_the_conv_at_pass_2_shapes(cuda, name):
    """Pass 2's shapes (128 rows, 72 rotations across ±π, a 256 × 256 grid,
    ``match_correlative``'s ±1.2 m window) at 181 and 361 beams, with a row
    of no valid point, a row whose points sit two to a cell, and rows with
    points off the grid: the kernel's volume equals the depthwise conv's bit
    for bit, and so does the flat argmax of each row."""
    model = S.PRESETS[name]
    ref, cur, rel = pairs(model, 128, 40, cuda)
    grid = correlative.build_likelihood_grid(model, ref)
    pts, ok = icp_points.scan_to_points(model, cur)
    pts, ok = pts.clone(), ok.clone()
    ok[0] = False                                  # an all-invalid row
    pts[1, 1::2] = pts[1, 0::2][:pts[1, 1::2].shape[0]]    # two points a cell
    pts[2, :40] += 30.0                            # off the grid at every rotation
    pts[3, :40] *= 20.0                            # some off it, some on it
    init = torch.as_tensor(rel, dtype=torch.float32, device=cuda)
    init[4, :2] = 12.0                             # the window over the grid's edge
    n_steps = int(1.2 / correlative.GRID_RES)      # match_correlative's window
    thetas = init[:, 2:3] + correlative._linspace(-np.pi, np.pi, 72, torch.float32, cuda)
    got, want, inb = _volume_pair(grid[None], pts, ok, thetas, init[:, :2],
                                  correlative.GRID_RES, correlative.GRID_HALF_EXTENT, n_steps)
    assert got.shape == (1, 128, 72, 2 * n_steps + 1, 2 * n_steps + 1)
    assert not inb[0].any() and not inb[2, :, :40].any() and inb[1].any()
    assert torch.equal(got, want), float((got - want).abs().max())
    assert torch.equal(got.flatten(2).argmax(-1), want.flatten(2).argmax(-1))
    assert got[0, 0].abs().max() == 0 and got.max() > 20


@pytest.mark.parametrize("n_points", [384, 768])
def test_sparse_volume_is_the_conv_at_loop_closure_shapes(cuda, n_points):
    """Loop closure's coarse search (0.3 m cells on ±12.8 m, ±5 m, 48
    rotations, 8 candidates) with the overlap normaliser's two planes, the
    grid and its cover: both planes equal the depthwise conv's bit for bit.
    Some points share a cell, some lie off the grid."""
    rng = np.random.default_rng(n_points)
    ref = torch.as_tensor(rng.uniform(-11, 11, (8, 768, 2)), dtype=torch.float32, device=cuda)
    grid = correlative.build_likelihood_grid_points(
        ref, torch.ones(8, 768, dtype=torch.bool, device=cuda), res=0.3, half_extent=12.8)
    pts = torch.as_tensor(rng.uniform(-14, 14, (8, n_points, 2)), dtype=torch.float32,
                          device=cuda)
    pts[:, n_points // 2:] = pts[:, :n_points - n_points // 2] + 0.01
    ok = torch.as_tensor(rng.uniform(size=(8, n_points)) > 0.1, device=cuda)
    init = torch.as_tensor(rng.normal(0, 1, (8, 3)), dtype=torch.float32, device=cuda)
    thetas, n_steps, _ = correlative._search_grid(init, 5.0, np.pi, 48, 0.3)
    planes = torch.stack([grid, correlative._cover(grid, 0.3, 1.5)])
    got, want, inb = _volume_pair(planes, pts, ok, thetas, init[:, :2], 0.3, 12.8, n_steps)
    assert got.shape == (2, 8, 48, 35, 35) and not inb.all()
    assert torch.equal(got, want), float((got - want).abs().max())
    assert got[1].max() > 10


def test_sparse_volume_wrapper_rejects_what_it_does_not_take(cuda):
    planes = torch.zeros(1, 2, 16, 16, device=cuda)
    cells = torch.zeros(2, 3, 5, dtype=torch.int32, device=cuda)
    before = correlative_kernel.score_volume_sparse.launches
    for p, c in (
        (planes, torch.zeros(2, 3, correlative_kernel.MAX_POINTS + 1, dtype=torch.int32,
                             device=cuda)),                  # above the most points
        (planes.double(), cells),                            # float64 grids
        (planes, cells.long()),                              # int64 ids
        (planes.transpose(2, 3), cells),                     # not contiguous
        (planes, cells.cpu()),                               # on two devices
    ):
        with pytest.raises(ValueError):
            correlative_kernel.score_volume_sparse(p, c, 3)
    assert correlative_kernel.score_volume_sparse.launches == before
    out = correlative_kernel.score_volume_sparse(
        planes, torch.zeros(2, 3, correlative_kernel.MAX_POINTS, dtype=torch.int32,
                            device=cuda), 3)
    torch.cuda.synchronize()
    assert out.shape == (1, 2, 3, 7, 7) and (out == 0).all()


def test_odometry_keyframe_launches_the_sparse_volume_once_a_chunk(cuda):
    """One ``odometry_keyframe`` on the card: pass 2 launches the kernel once
    for each chunk of re-matched steps, and the profiler counts the launches
    and the (row, rotation) pairs; no volume goes through the conv."""
    model = S.LMS211
    scans, ts = synthetic_scans(model, 300, cuda, blind=(40, 41, 90))
    before = correlative_kernel.score_volume_sparse.launches
    profiler.reset()
    profiler.enable()
    try:
        res = odometry.odometry_keyframe(model, scans, deep_chunk=8, timestamps=ts)
        torch.cuda.synchronize()
        counts = profiler.counts()
    finally:
        profiler.disable()
        profiler.reset()
    chunks = -(-int(res.rematched.sum()) // 8)
    assert chunks >= 2
    assert correlative_kernel.score_volume_sparse.launches == before + chunks
    assert counts["correlative.volume_launches"] == chunks
    assert counts["correlative.volume_rows"] == chunks * 8 * 72


# Pairs of the synthetic log's first 400 scans (anchors every 10 scans): six
# true revisits of the first doorway, a far pair and an invalid one.
SRC = np.asarray([12, 11, 15, 13, 10, 16, 2, 5])
DST = np.asarray([27, 28, 24, 26, 29, 23, 30, 38])
# A verified loop's relative pose, card against CPU [m, rad]: both run the
# same PyTorch program; the sums run in another order.
REL_ATOL = 1e-3


def test_verify_pairs_correlative_on_cuda_matches_cpu(cuda):
    """One chunk of eight candidates through the whole verifier (48
    rotation samples, 384- and 768-point clouds built from the ground-truth
    poses) on the card and on the CPU: every pair whose scores all lie away
    from their gates gets the same strict and tentative flags and the same
    lane, and the accepted relative poses agree."""
    model = S.LMS211
    scans, _ = synthetic_scans(model, 400, torch.device("cpu"))
    gt, _ = synthetic_log.trajectory(400)
    poses = torch.as_tensor(se2.np_relative(gt[0], gt), dtype=torch.float32)
    sm = submap.build_submaps(model, scans, poses, 10, 384)
    ap = poses[::10]
    wp, wo = submap.wide_clouds(sm, ap, wing=4, max_points=768)
    src, dst = torch.as_tensor(SRC), torch.as_tensor(DST)
    est = se2.relative(ap[src], ap[dst])
    est[:, :2] += 0.6
    valid = torch.ones(8, dtype=torch.bool)
    valid[-1] = False
    args = (wp[src], wo[src], sm.points[src], sm.valid[src], wp[dst], wo[dst], sm.points[dst],
            sm.valid[dst], est, valid, torch.full((8,), 3.0))
    kw = dict(search_xy=5.0, n_theta=48, coarse_res=0.3, n_peaks=4, chunk=0, identity_init=True)
    want = loop_closure.verify_pairs_correlative(*args, **kw)
    got = loop_closure.verify_pairs_correlative(*(x.to(cuda) for x in args), **kw)
    assert got.rel.device.type == cuda.type
    d = {k: v.numpy() for k, v in want.diag.items()}
    # Away from a gate: no score within 5 % of one of its thresholds.
    gates = (("goodness", (0.35, 0.6, 0.8)), ("err", (0.03, 0.04, 0.05)), ("cycle_t", (0.25, 0.3)),
             ("cycle_r", (0.1,)), ("coarse_score", (0.2, 0.6)))
    clear = np.ones(8, bool)
    for k, thresholds in gates:
        for thr in thresholds:
            clear &= np.abs(d[k] - thr) > 0.05 * thr
    assert clear.sum() >= 5, clear
    for g, w in ((got.accept, want.accept), (got.tentative, want.tentative),
                 (got.diag["lane"], want.diag["lane"])):
        np.testing.assert_array_equal(g.cpu().numpy()[clear], w.numpy()[clear])
    both = (want.accept | want.tentative).numpy() & (got.accept | got.tentative).cpu().numpy()
    assert want.accept.sum() >= 2 and both.sum() >= 3
    np.testing.assert_allclose(got.rel.cpu().numpy()[both], want.rel.numpy()[both], atol=REL_ATOL)
    np.testing.assert_allclose(got.quality.cpu().numpy()[both], want.quality.numpy()[both],
                               atol=REL_ATOL)
    assert not (got.accept | got.tentative)[6:].any()


def test_cli_slam_on_cuda_twice(cuda, tmp_path, capsys):
    """``cli slam`` on 300 scans of the synthetic log, on ``cuda`` (the
    default device), twice: K1's chain entry runs the front end, loops are
    closed, and the output says whether the two runs are bit-identical (the
    normal system is assembled with floating-point atomics)."""
    path = str(tmp_path / "synthetic.log")
    synthetic_log.write_carmen(path, *synthetic_log.synthetic_log(n_scans=300, n_whips=0))
    runs = []
    for _ in range(2):
        before = psm_kernel.odometry_chain_fused.launches
        run = cli.main(["slam", path, "--max-loops", "64", "--rounds", "2"])
        torch.cuda.synchronize()
        assert psm_kernel.odometry_chain_fused.launches == before + 1
        assert run.result.poses.device.type == "cuda"
        poses = run.result.poses.cpu().numpy()
        assert poses.shape == (300, 3) and np.isfinite(poses).all()
        assert int(run.result.n_loops) == run.diag["bank"]["used"].sum() >= 3
        assert float(run.ate.rmse) < float(run.ate_odo.rmse)
        assert len(run.diag["timing"]["verify"]) == 4
        runs.append(poses)
    diff = float(np.abs(runs[0] - runs[1]).max())
    with capsys.disabled():
        print(f"\ncli slam twice on cuda: bit-identical {diff == 0.0}, max |dpose| {diff:.3g}")
    assert diff < 1e-2


# -- the online session and localization on the card ---------------------------

def _online_scans(n):
    ranges, gt, _ = synthetic_log.synthetic_log(n_scans=n, n_whips=1)
    return ranges.astype(np.float32), gt


def _small_online_cfg():
    import dataclasses

    from laser_slam_tpu_torch.runtime.slam import SlamConfig

    return dataclasses.replace(
        SlamConfig(), submap_points=256, wide_points=512, max_loops=64, verify_chunk=16,
        n_theta=24, n_peaks=4, per_dst=6, search_xy=3.0, gn_iters=10)


def test_feed_scan_on_the_card_matches_the_cpu_session(cuda):
    """300 synthetic scans (one whip behind a dt gap, so the inline ±π
    fallback runs) through ``OnlineSlam`` on the card and on the CPU, no
    backend round: one K1 launch of two pairs a scan and no other route,
    the same weak and fracture flags. Float transcendentals differ between
    the devices in the last bit, so a pair's PSM match may stop a few mm
    apart and the chains drift apart with the scans: held are the
    per-scan relative motions, at the cross-device bounds of the kernel's
    own parity test (median 5 mm / 0.1°, worst 0.15 m / 2°), and the end
    of the 300-scan chain within 0.5 m."""
    from laser_slam_tpu_torch.runtime.online import OnlineSlam

    ranges, _ = _online_scans(300)
    pad = S.pad_beams(ranges, S.LMS211.n_beams, S.LMS211.max_range + 1.0)
    sessions = {}
    for dev in ("cuda", "cpu"):
        slam = OnlineSlam(S.LMS211, optimize_every=10 ** 6, use_fusion=True, device=dev)
        before = psm_kernel.match_psm_fused.launches
        for r in pad:
            slam.feed_scan(r)
        sessions[dev] = (slam, psm_kernel.match_psm_fused.launches - before)
    (g, g_launches), (c, c_launches) = sessions["cuda"], sessions["cpu"]
    assert g_launches == 299 and c_launches == 0
    assert g._carry.last_gpose.device.type == "cuda" and g._imap.grid.log_odds.device.type == "cuda"
    assert g._weak == c._weak and g._fracture == c._fracture and sum(g._weak) >= 1
    steps = [se2.np_relative(s.trajectory[:-1], s.trajectory[1:]) for s in (g, c)]
    d = steps[0] - steps[1]
    dt, dr = np.linalg.norm(d[:, :2], axis=1), np.abs((d[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    assert np.median(dt) < 5e-3 and dt.max() < 0.15, (np.median(dt), dt.max())
    assert np.degrees(np.median(dr)) < 0.1 and np.degrees(dr.max()) < 2.0
    assert np.linalg.norm(g.trajectory[-1, :2] - c.trajectory[-1, :2]) < 0.5
    assert np.linalg.norm(g.pose[:2] - c.pose[:2]) < 0.5
    # The live maps: as much wall in both (the chains drift apart by more
    # than a 0.1 m cell, so the cells themselves are not compared).
    a, b = (g._imap.grid.log_odds > 0).sum().item(), (c._imap.grid.log_odds > 0).sum().item()
    assert b > 500 and abs(a - b) < 0.2 * b


def test_async_session_on_its_own_stream_ends_where_the_sync_one_does(cuda):
    """The async session (worker thread, a CUDA stream of its own) and the
    synchronous one over the 170-scan box loop: after ``flush`` the final
    trajectories agree to 0.25 m, the bound the JAX package's own test of
    this property holds, and both close the lap. The frontends are the
    same launches on the same inputs, so before any round applies they
    agree exactly."""
    from laser_slam_tpu_torch.runtime.online import OnlineSlam

    model = S.LaserModel(**synthetic_log.BOX_LOOP_MODEL)
    scans = synthetic_log.box_loop_scans(170)
    out = {}
    for mode in (False, True):
        slam = OnlineSlam(model, cfg=_small_online_cfg(), optimize_every=4,
                          incremental_map=False, async_backend=mode, device=cuda)
        for r in scans:
            slam.feed_scan(r)
        if mode:
            slam.flush()
            assert slam._bg_stream is not None
            assert slam._bg_stream != torch.cuda.current_stream(cuda)
        else:
            slam._backend_round()
        bank = slam._backend._bank
        assert int((bank["act"] & bank["strict"]).sum()) >= 1
        out[mode] = slam
    s, a = out[False], out[True]
    assert a.async_stats["started"] >= 2 and a.async_stats["applied"] >= 1
    assert a._bg_result is None and not a._pending_round and not a._bg_thread.is_alive()
    np.testing.assert_array_equal(np.stack(a._odo_chain)[:70], np.stack(s._odo_chain)[:70])
    dev = np.linalg.norm(s.trajectory[:, :2] - a.trajectory[:, :2], axis=1)
    assert float(dev.max()) < 0.25, f"sync/async final trajectories diverge {dev.max():.3f} m"


def test_update_beam_in_chunks_equals_unchunked(cuda):
    """``update_beam`` at 384 particles on a 0.1 m grid (S = 500 samples a
    beam: 384 x 181 x 500 fits in one piece) in chunks of 100 and in one
    piece: the same log-weights to float round-off. And the card against
    the CPU on the same cloud: 1e-4."""
    from laser_slam_tpu_torch.localization import particle_filter as pf
    from laser_slam_tpu_torch.mapping import occupancy as occ

    model = S.LMS211
    ranges, gt = _online_scans(120)
    pad = S.pad_beams(ranges, model.n_beams, model.max_range + 1.0)
    scans = pp.preprocess(torch.as_tensor(pad, device=cuda), model)
    poses = torch.as_tensor(gt, dtype=torch.float32, device=cuda)
    spec = occ.spec_for_trajectory(gt, model.max_range, 0.1)
    grid = occ.integrate_scans(occ.empty_grid(spec, device=cuda), model, scans, poses)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    state = pf.init_gaussian(gen, poses[60], 384, sigma_xy=0.1, sigma_theta=0.05)
    obs, valid = scans.ranges[60], ~scans.bad[60]
    whole = pf.update_beam(state, grid, model, obs, valid)
    parts = pf.update_beam(state, grid, model, obs, valid, chunk=100)
    np.testing.assert_allclose(parts.log_w.cpu().numpy(), whole.log_w.cpu().numpy(), atol=1e-6)
    cpu_state = pf.ParticleState(state.poses.cpu(), state.log_w.cpu())
    cpu_grid = occ.OccupancyGrid(grid.log_odds.cpu(), spec)
    on_cpu = pf.update_beam(cpu_state, cpu_grid, model, obs.cpu(), valid.cpu(), chunk=100)
    # A ray sample on a cell edge may read the neighbouring cell on the
    # other device (last bits of cos/sin): a few particles' weights move.
    d = np.abs(parts.log_w.cpu().numpy() - on_cpu.log_w.numpy())
    assert (d > 1e-4).mean() < 0.05 and d.max() < 0.1


@pytest.fixture(scope="module")
def beam_cell():
    """One tick of the beam-model cell's shape on the card
    (``tools/beam_cell.py``): a 2 cm map of 5.7 k x 5.5 k cells, 4096 poses
    of cm spread around the ground truth, 361 beams of 50 m."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return cell.beam_cell(device="cuda")


def test_ray_march_is_the_ladder_at_the_cell_shape(beam_cell):
    """The kernel's ranges at 4096 x 361 rays of 2500 samples equal the
    dense ladder's bit for bit (the ladder in chunks of 61 poses, as
    ``update_beam`` ran it); one launch a call."""
    grid, model, cloud, _, _ = beam_cell
    before = raycast_kernel.ray_march.launches
    got = raycast.simulate_scan(grid, model, cloud)
    torch.cuda.synchronize()
    assert raycast_kernel.ray_march.launches == before + 1
    want = cell.ladder_in_chunks(grid, model, cloud)
    assert got.shape == (4096, 361)
    assert torch.equal(got, want), float((got - want).abs().max())
    hit = want < model.max_range
    assert 0.5 < float(hit.float().mean()) and float(want.min()) > 0


# A map of x in [-3.5, 3], y in [-3, 3] of the 8 x 8 m room (x in [-3, 5],
# y in [-4, 4]): three of its walls lie off the map, so most rays leave it.
ROOM_SPEC = (-3.5, -3.0, 0.05, 130, 120)
ROOM_MODEL = S.LMS211.with_start(-np.pi / 2, 10.0)


def _room_on(dev):
    """The room seen from ten poses, integrated into the map of
    ``ROOM_SPEC``, with the band y in [1.5, 2.0) reset to unknown cells;
    a cloud near one pose and poses off the map, each facing it or not."""
    from laser_slam_tpu_torch.mapping import occupancy as occ

    poses = np.asarray([(-1.0 + 0.15 * i, 1.0 - 0.05 * i, -1.0 + 0.3 * i) for i in range(10)],
                       np.float32)
    r = synthetic_log.ray_cast(synthetic_log.room_walls(), poses.astype(np.float64),
                               ROOM_MODEL.bearings(torch.float64).numpy(), ROOM_MODEL.max_range)
    scans = pp.preprocess(torch.as_tensor(r.astype(np.float32), device=dev), ROOM_MODEL)
    spec = occ.GridSpec2D(*ROOM_SPEC)
    grid = occ.integrate_scans(occ.empty_grid(spec, device=dev), ROOM_MODEL, scans,
                               torch.as_tensor(poses, device=dev))
    log_odds = grid.log_odds.clone()
    log_odds[90:100] = 0.0
    rng = np.random.default_rng(0)
    near = poses[2] + rng.normal(0.0, 1.0, (18, 3)) * np.asarray([0.02, 0.02, 0.01])
    off = [(3.6, 0.5, np.pi), (0.0, 3.4, -1.5), (0.5, -3.3, 1.7), (-4.0, 0.0, np.pi),
           (-4.0, 0.0, 0.0), (100.0, 100.0, 0.3)]
    cloud = np.concatenate([near, np.asarray(off)]).astype(np.float32)
    return occ.OccupancyGrid(log_odds, spec), scans, torch.as_tensor(cloud, device=dev)


@pytest.mark.parametrize("shape", [(), (24,), (4, 6)])
@pytest.mark.parametrize("max_range,occ_threshold", [(None, 0.5), (3.0, 0.5), (None, 0.7),
                                                     (2.0, 0.3)])
def test_ray_march_is_the_ladder_at_edge_cases(cuda, shape, max_range, occ_threshold):
    """Poses off the map, rays leaving it, rays through unknown cells, a
    range shorter than the model's, other thresholds, and poses ``[3]``,
    ``[P, 3]``, ``[A, B, 3]``: the kernel equals the ladder bit for bit."""
    grid, _, cloud = _room_on(cuda)
    poses = cloud[: int(np.prod(shape)) or 1].reshape(*shape, 3)
    before = raycast_kernel.ray_march.launches
    got = raycast.simulate_scan(grid, ROOM_MODEL, poses, max_range, occ_threshold)
    torch.cuda.synchronize()
    assert raycast_kernel.ray_march.launches == before + 1
    m = ROOM_MODEL.max_range if max_range is None else max_range
    want = raycast._simulate_scan_ladder(grid, ROOM_MODEL, poses, max_range, occ_threshold)
    assert got.shape == (*shape, ROOM_MODEL.n_beams)
    assert torch.equal(got, want), float((got - want).abs().max())
    if shape:
        assert (want < m).any() and (want == m).any()


@pytest.mark.parametrize("chunk", [None, 100])
@pytest.mark.parametrize("all_invalid", [False, True])
def test_update_beam_through_the_kernel_is_the_ladder(cuda, beam_cell, monkeypatch, chunk,
                                                      all_invalid):
    """``update_beam`` at the cell's shape through the kernel (the whole
    cloud in one launch, or a launch a chunk of 100) against the ladder in
    the chunks it takes (61 poses fill 2 GiB, or 100): the log-weights
    equal bit for bit."""
    from laser_slam_tpu_torch.localization import particle_filter as pf

    grid, model, cloud, ranges, valid = beam_cell
    if all_invalid:
        valid = torch.zeros_like(valid)
    state = pf.ParticleState(cloud, torch.full((cloud.shape[0],), -np.log(cloud.shape[0]),
                                               device=cuda))
    before = raycast_kernel.ray_march.launches
    got = pf.update_beam(state, grid, model, ranges, valid, chunk=chunk)
    torch.cuda.synchronize()
    assert raycast_kernel.ray_march.launches == before + (1 if chunk is None else 41)

    monkeypatch.setattr(raycast, "simulate_scan", raycast._simulate_scan_ladder)
    want = pf.update_beam(state, grid, model, ranges, valid, chunk=chunk or 61)
    assert torch.equal(got.log_w, want.log_w) and torch.equal(got.poses, want.poses)


@pytest.mark.parametrize("n_beams", [181, 361])
@pytest.mark.parametrize("poses,rows", [(4096, 61), (4096, 100), (1000, 16), (1000, 7),
                                        (1000, 1000), (30, 61)])
def test_sum_in_chunks_is_the_chunked_sum(cuda, n_beams, poses, rows):
    """Row sums on the card as calls of ``rows`` rows take them, bit for
    bit, where one call over all rows differs in the last bit."""
    x = torch.rand(poses, n_beams, generator=torch.Generator(cuda).manual_seed(rows),
                   device=cuda)
    want = torch.cat([x[i:i + rows].clone().sum(-1) for i in range(0, poses, rows)])
    assert torch.equal(raycast._sum_in_chunks(x, rows), want)
    if (poses, rows) == (4096, 61):
        assert not torch.equal(x.sum(-1), want)


def test_ray_march_wrapper_rejects_what_it_does_not_take(cuda):
    occupied = torch.zeros(4, 5, dtype=torch.bool, device=cuda)
    pose = torch.zeros(2, 3, device=cuda)
    c = torch.ones(2, 7, device=cuda)
    args = (0.0, 0.0, 0.05, 100, 5.0)
    before = raycast_kernel.ray_march.launches
    for bad in ((occupied.cpu(), pose.cpu(), c.cpu(), c.cpu()),            # CPU tensors
                (occupied, pose.double(), c.double(), c.double()),         # float64
                (occupied, pose, c, c.cpu()),                              # on two devices
                (occupied.float(), pose, c, c),                            # a map of floats
                (occupied, pose, c.t().contiguous().t(), c)):              # not contiguous
        with pytest.raises(ValueError):
            raycast_kernel.ray_march(*bad, *args)
    with pytest.raises(ValueError, match="float32"):
        raycast.simulate_scan(_room_on(cuda)[0], ROOM_MODEL, pose.double())
    assert raycast_kernel.ray_march.launches == before
    out = raycast_kernel.ray_march(occupied, pose, c, c, *args)
    torch.cuda.synchronize()
    assert raycast_kernel.ray_march.launches == before + 1
    assert out.shape == (2, 7) and (out == 5.0).all()


def test_update_raycast_icp_on_the_card_against_the_cpu(cuda):
    """The ray-cast + ICP update of 64 poses around one of the room's on the
    card (one march launch) and on the CPU (the ladder). A ray sample on a
    cell edge may read the neighbouring cell on the other device (last bits
    of cos/sin), which moves a simulated point by a cell, and ``atan2``'s
    last bit differs between the devices: a particle's match may settle
    apart and count a point more or less. So the fail flags must agree,
    the poses at the median within 1 mm and at the worst within 2 cm (a
    cell), and at most a tenth of the log-weights may move by over 1e-3."""
    from laser_slam_tpu_torch.localization import particle_filter as pf

    grid, scans, _ = _room_on(cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    true = torch.tensor([-0.7, 0.9, -0.4], device=cuda)      # the room's pose 2
    poses = true + torch.randn(
        64, 3, generator=g, device=cuda) * torch.tensor([0.05, 0.05, 0.03], device=cuda)
    state = pf.ParticleState(poses, torch.full((64,), -np.log(64.0), device=cuda))
    ranges, valid = scans.ranges[2], ~scans.bad[2]
    before = raycast_kernel.ray_march.launches
    card = pf.update_raycast_icp(state, grid, ROOM_MODEL, ranges, valid)
    torch.cuda.synchronize()
    assert raycast_kernel.ray_march.launches == before + 1
    host = pf.update_raycast_icp(
        pf.ParticleState(poses.cpu(), state.log_w.cpu()),
        type(grid)(grid.log_odds.cpu(), grid.spec), ROOM_MODEL, ranges.cpu(), valid.cpu())
    assert raycast_kernel.ray_march.launches == before + 1
    d = np.hypot(*(card.poses.cpu().numpy()[:, :2] - host.poses.numpy()[:, :2]).T)
    assert np.median(d) < 1e-3 and d.max() < 2e-2, (np.median(d), d.max())
    w = np.abs(card.log_w.cpu().numpy() - host.log_w.numpy())
    assert (w > 1e-3).mean() <= 0.1, np.sort(w)[-8:]
    # The nudge pulls the cloud towards the pose the scan was taken from.
    spread = [float(torch.hypot(*(p[:, :2] - true[:2]).T).mean()) for p in (poses, card.poses)]
    assert spread[1] < spread[0], spread


def test_update_raycast_icp_at_the_cell_shape_credits_pf_icp(beam_cell):
    """One ray-cast + ICP update at the cell's shape (4096 poses, 361 beams,
    a 2 cm map): one march launch, the ICP in one chunk (the search is the
    kernel, so an iteration holds ``[P, N]`` tensors, not ``[P, N, N]``),
    one search launch an iteration and 4096 · 361² · 10 pairs counted;
    under a ``torch.profiler`` window ``benchmark/harness.summarize``
    credits ``pf.icp`` with the ICP's kernels, most of the update's device
    time, ``h1_nearest_two`` with the search kernel through its operator,
    and ``pf.raycast`` with the march."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness
    from laser_slam_tpu_torch.localization import particle_filter as pf

    grid, model, cloud, ranges, valid = beam_cell
    state = pf.ParticleState(cloud, torch.full((cloud.shape[0],), -np.log(cloud.shape[0]),
                                               device=cloud.device))
    warm = pf.update_raycast_icp(state, grid, model, ranges, valid)
    profiler.reset()
    before = raycast_kernel.ray_march.launches
    searches = icp_nearest_kernel.nearest_two.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = pf.update_raycast_icp(state, grid, model, ranges, valid)
        torch.cuda.synchronize()
    counts = profiler.counts()
    profiler.reset()
    assert raycast_kernel.ray_march.launches == before + 1
    assert icp_nearest_kernel.nearest_two.launches == searches + 10
    assert torch.equal(got.log_w, warm.log_w) and torch.equal(got.poses, warm.poses)
    assert counts["pf.icp_pairs"] == 4096 * 361 * 361 * 10 and counts["pf.icp_chunks"] == 1
    assert counts["icp.nearest_two_launches"] == 10
    assert counts["pf.raycast_rays"] == 4096 * 361 and counts["pf.raycast_chunks"] == 1
    ranges_s = harness.summarize(prof, 1.0).range_device_s
    for name in ("pf.update", "pf.raycast", "pf.icp", "h1_nearest_two"):
        assert ranges_s[name][1] > 0, (name, ranges_s.get(name))
    assert ranges_s["pf.icp"][1] > 0.6 * ranges_s["pf.update"][1], ranges_s
    assert ranges_s["h1_nearest_two"][1] <= ranges_s["pf.icp"][1], ranges_s
    assert int((~torch.isfinite(got.log_w)).sum()) == 0
    names = {e.key for e in prof.key_averages()}
    assert any("nearest_two_kernel" in k for k in names), sorted(names)


def test_reloc_sampler_is_the_references_at_the_cell_shape(beam_cell):
    """The table of the 2 cm map's free cells and 10,000 samples drawn
    from it on the card equal the benchmark reference's bit for bit, and
    every sample lies in a free cell by the map's own lookup."""
    from benchmark.reference import relocalize_icp as ref
    from laser_slam_tpu_torch.localization import particle_filter as pf

    grid = beam_cell[0]
    free = pf.free_cells(grid)
    assert torch.equal(free, ref.free_cells(grid.log_odds))
    assert 100_000 < free.numel() < grid.log_odds.numel() // 10
    u = torch.rand(10_000, 4, generator=torch.Generator(device="cuda").manual_seed(2),
                   device="cuda")
    poses = pf.free_space_poses(free, grid.spec, u)
    assert torch.equal(poses, ref.sample(free, grid.spec, u))
    ix, iy = grid.spec.world_to_cell(poses[:, :2]).unbind(-1)
    assert bool((grid.log_odds[iy, ix] < 0).all())


def test_reloc_at_the_cell_shape_against_the_reference(beam_cell):
    """One relocalization at the cell's shape (10,000 free-space samples,
    361 beams, the 2 cm map, 4096 kept) on the card: the scoring of every
    sample against the reference's (99th percentiles over the samples of
    the log-weight and pose gaps under the cell's limits; the kept cloud's
    log-weights by rank, their mean gap and 99th percentile); one march
    launch, the ICP in one chunk, ten
    search launches; ``pf.relocalize`` credited with the update's device
    time under a ``torch.profiler`` window."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness
    from benchmark.reference import relocalize_icp as ref
    from laser_slam_tpu_torch.localization import particle_filter as pf

    grid, model, _, ranges, valid = beam_cell
    free = pf.free_cells(grid)
    u = torch.rand(10_000, 4, generator=torch.Generator(device="cuda").manual_seed(3),
                   device="cuda")
    poses = pf.free_space_poses(free, grid.spec, u)
    warm = pf.global_relocalize_at(u, free, "icp", grid, None, model, ranges, valid, 4096)
    profiler.reset()
    before = raycast_kernel.ray_march.launches
    searches = icp_nearest_kernel.nearest_two.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = pf.global_relocalize_at(u, free, "icp", grid, None, model, ranges, valid, 4096)
        torch.cuda.synchronize()
    counts = profiler.counts()
    profiler.reset()
    assert torch.equal(got.log_w, warm.log_w) and torch.equal(got.poses, warm.poses)
    assert raycast_kernel.ray_march.launches == before + 1
    assert icp_nearest_kernel.nearest_two.launches == searches + 10
    assert counts["pf.reloc_samples"] == 10_000 and counts["pf.reloc_kept"] == 4096
    assert counts["pf.icp_pairs"] == 10_000 * 361 * 361 * 10 and counts["pf.icp_chunks"] == 1
    ranges_s = harness.summarize(prof, 1.0).range_device_s
    assert ranges_s["pf.relocalize"][1] >= ranges_s["pf.update"][1] > 0, ranges_s
    equal = torch.full((10_000,), -np.log(10_000.0), device="cuda")
    scored = pf.update_raycast_icp(pf.ParticleState(poses, equal), grid, model, ranges, valid)
    want_scored, want_kept = ref.relocalize(poses, grid, model, ranges, valid, 4096)
    dw = (scored.log_w - want_scored.log_w).abs().double().cpu().numpy()
    dt, dr = harness.pose_gaps(scored.poses.double().cpu().numpy(),
                               want_scored.poses.double().cpu().numpy())
    assert np.percentile(dw, 99) < 0.01 and np.percentile(dt, 99) < 0.005
    assert np.percentile(dr, 99) < 0.002
    by_rank = (got.log_w - want_kept.log_w).abs().double().cpu().numpy()
    assert by_rank.mean() < 0.005 and np.percentile(by_rank, 99) < 0.1
    assert got.poses.shape == (4096, 3) and bool(torch.isfinite(got.log_w).all())


def _search_both(q, ref, ok):
    """The kernel's search and the plain block's on the same card."""
    got = icp_points._nearest_two(q, ref, ok)
    want = icp_points._nearest_two_plain(q, ref, ok)
    torch.cuda.synchronize()
    return got, want


def _assert_same_search(got, want):
    for name, g, w in zip(("j", "j2", "nn_ok"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))


def test_nearest_two_is_the_plain_search_at_the_icp_cell_shape(beam_cell):
    """The first iteration's search of the icp cell's tick (4096 particles,
    each one's 361 simulated points with the march's hit mask, the 361
    observed points moved by its pose) in one launch, against the plain
    block in chunks of 1024 as the parent searched: bit for bit."""
    grid, model, cloud, ranges, valid = beam_cell
    sim_pts, sim_ok, _, _, q = icp_cases.cell_clouds(grid, model, cloud, ranges, valid)
    before = icp_nearest_kernel.nearest_two.launches
    got = icp_points._nearest_two(q, sim_pts, sim_ok)
    assert icp_nearest_kernel.nearest_two.launches == before + 1
    want = [torch.cat(x) for x in zip(*(
        icp_points._nearest_two_plain(q[i:i + 1024], sim_pts[i:i + 1024], sim_ok[i:i + 1024])
        for i in range(0, 4096, 1024)))]
    torch.cuda.synchronize()
    _assert_same_search(got, want)
    assert float(sim_ok.float().mean()) > 0.3 and bool(got[2].any())


@pytest.mark.parametrize("name", ["LMS211", "LMS511"])
def test_nearest_two_is_the_plain_search_at_pass_2_shapes(cuda, name):
    """128 pairs of room scans at 181 and 361 beams, the previous scan's
    valid points as the reference (pass 2's polish): bit for bit."""
    model = getattr(S, name)
    ref, cur, rel = pairs(model, 128, 41, cuda)
    ref_pts, ref_ok = icp_points.scan_to_points(model, ref)
    cur_pts, _ = icp_points.scan_to_points(model, cur)
    init = torch.as_tensor(rel, dtype=torch.float32, device=cuda)
    _assert_same_search(*_search_both(se2.transform_points(init, cur_pts), ref_pts, ref_ok))


@pytest.mark.parametrize("case", ["edges", "edges_float64_plain", "expanded_over_tiles", "strided",
                                  "many_tiles_of_points", "empty_batch"])
def test_nearest_two_is_the_plain_search_at_edge_cases(cuda, case):
    """Ties (the lower index first), a row with no candidate, with one,
    points that are not finite, masked points of any value; a reference
    cloud of 9001 points (three shared-memory tiles) expanded over 64
    rows with stride 0 and never copied; a reference taken every other
    point; 1500 observed points a row (two blocks of points); no rows."""
    before = icp_nearest_kernel.nearest_two.launches
    if case.startswith("edges"):
        q, ref, ok = (torch.as_tensor(x, device=cuda) for x in icp_cases.edge_cases())
        if case == "edges_float64_plain":       # another dtype takes the plain block
            q, ref = q.double(), ref.double()
            got = icp_points._nearest_two(q, ref, ok)
            assert icp_nearest_kernel.nearest_two.launches == before
            _assert_same_search(got, icp_points._nearest_two_plain(q, ref, ok))
            return
    elif case == "expanded_over_tiles":
        q, ref, ok = (torch.as_tensor(x, device=cuda) for x in icp_cases.scan_clouds(64, 361, 9001, 3))
        ref, ok = ref[:1].expand(64, 9001, 2), ok[:1].expand(64, 9001)
        assert ref.stride(0) == 0 and ok.stride(0) == 0
    elif case == "strided":
        q, ref, ok = (torch.as_tensor(x, device=cuda) for x in icp_cases.scan_clouds(32, 181, 722, 4))
        ref, ok = ref[:, ::2], ok[:, ::2]
    elif case == "many_tiles_of_points":
        q, ref, ok = (torch.as_tensor(x, device=cuda) for x in icp_cases.scan_clouds(8, 1500, 361, 5))
    else:
        q, ref, ok = (torch.as_tensor(x, device=cuda) for x in icp_cases.scan_clouds(3, 50, 40, 6))
        q = q[:0]
        ref, ok = ref[:0], ok[:0]
    got, want = _search_both(q, ref, ok)
    _assert_same_search(got, want)
    assert icp_nearest_kernel.nearest_two.launches == before + (case != "empty_batch")
    if case == "edges":
        j, j2, nn_ok = (x.cpu().numpy() for x in got)
        assert j[0, 3] == 2 and j2[0, 3] == 5 and not nn_ok[2].any() and (j2[3] == 0).all()


def test_nearest_two_wrapper_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(2, 5, 2, device=cuda)
    ref = torch.zeros(2, 7, 2, device=cuda)
    ok = torch.ones(2, 7, dtype=torch.bool, device=cuda)
    before = icp_nearest_kernel.nearest_two.launches
    for bad in ((q, ref, ok.cpu()), (q.cpu(), ref, ok), (q, ref.double(), ok),
                (q, ref, ok[:, :3]), (q, ref[:, :0], ok[:, :0])):
        with pytest.raises(ValueError):
            icp_nearest_kernel.nearest_two(*bad)
    assert icp_nearest_kernel.nearest_two.launches == before
    j, j2, nn_ok = icp_nearest_kernel.nearest_two(q, ref, ok)
    torch.cuda.synchronize()
    assert icp_nearest_kernel.nearest_two.launches == before + 1
    assert (j == 0).all() and (j2 == 1).all() and nn_ok.all()


@pytest.mark.parametrize("what", ["icp_cell_chunks", "pass_2_polish"])
def test_match_icp_points_on_the_card_is_the_frozen_copy(beam_cell, what):
    """The whole match on the card, the kernel's search inside, bit for bit
    the benchmark's frozen ``match_icp_points`` (the plain search written
    inline) on the same inputs: the icp cell's tick in its parent's chunks
    of 1024 (10 iterations from 0.6 m), and pass 2's 15-iteration polish
    of 128 pairs at 181 and 361 beams (0.3 m)."""
    from benchmark.reference.slam.ops import icp_points as frozen

    dev = torch.device("cuda")
    if what == "icp_cell_chunks":
        grid, model, cloud, ranges, valid = beam_cell
        sim_pts, sim_ok, scan_pts, scan_ok, _ = icp_cases.cell_clouds(
            grid, model, cloud, ranges, valid)
        calls = [((sim_pts[i:i + 1024], sim_ok[i:i + 1024], scan_pts[i:i + 1024],
                   scan_ok[i:i + 1024], cloud[i:i + 1024]), dict(iters=10, max_corr=0.6))
                 for i in range(0, 4096, 1024)]
    else:
        calls = []
        for model in (S.LMS211, S.LMS511):
            ref, cur, rel = pairs(model, 128, 43, dev)
            init = torch.as_tensor(rel, dtype=torch.float32, device=dev)
            calls.append(((*icp_points.scan_to_points(model, ref),
                           *icp_points.scan_to_points(model, cur), init),
                          dict(iters=15, max_corr=0.3)))
    before = icp_nearest_kernel.nearest_two.launches
    for args, kw in calls:
        got = icp_points.match_icp_points(*args, **kw)
        want = frozen.match_icp_points(*args, **kw)
        torch.cuda.synchronize()
        for name, g, w in zip(got._fields, got, want):
            assert torch.equal(g, w), (what, name)
    assert icp_nearest_kernel.nearest_two.launches == before + sum(kw["iters"] for _, kw in calls)


def test_systematic_resample_on_the_card_against_the_cpu(cuda):
    """A float32 ``cumsum`` on the card is a parallel scan with another
    summation order than the CPU's, so an index at a boundary can differ
    by one: held is the count of differing indices (under 1 %), not
    equality."""
    from laser_slam_tpu_torch.localization import particle_filter as pf

    rng = np.random.default_rng(0)
    poses = torch.as_tensor(rng.normal(0, 1, (4096, 3)).astype(np.float32))
    poses[:, 0] = torch.arange(4096)           # the row's own index, to read the choice back
    log_w = torch.as_tensor(rng.normal(0, 2.0, 4096).astype(np.float32))
    log_w = log_w - torch.logsumexp(log_w, 0)
    on_cpu = pf.systematic_resample_at(pf.ParticleState(poses, log_w), 0.37)
    on_card = pf.systematic_resample_at(pf.ParticleState(poses.to(cuda), log_w.to(cuda)), 0.37)
    i_cpu, i_card = on_cpu.poses[:, 0].numpy(), on_card.poses[:, 0].cpu().numpy()
    differ = i_cpu != i_card
    assert differ.mean() < 0.01 and np.abs(i_cpu - i_card).max() <= 1


# -- the PF tick's phases as captured CUDA graphs -------------------------------

@pytest.fixture(scope="module")
def field_lap():
    """``fr079.localize``'s shape at a third of its length on the card: a
    160-scan synthetic log at 361 beams, the 5 cm map of its first half at
    ground truth and the map's likelihood field. Returns ``(model, scans,
    gt, grid, field)``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    from laser_slam_tpu_torch.mapping import occupancy as occ

    dev = torch.device("cuda")
    model = S.PRESETS["LMS511"].with_start(-np.pi / 2)
    synth = synthetic_log
    gt, _ = synth.trajectory(160, seed=3)
    r = synth.ray_cast(synth.floor_plan(), gt, model.bearings(torch.float64).numpy())
    rng = np.random.default_rng(4)
    r = np.where(r <= synth.MAX_RANGE, r + rng.normal(0.0, synth.NOISE, r.shape), r)
    scans = pp.preprocess(torch.as_tensor(r.astype(np.float32), device=dev), model)
    poses = torch.as_tensor(gt, dtype=torch.float32, device=dev)
    spec = occ.spec_for_trajectory(gt, model.max_range, 0.05)
    grid = occ.integrate_scans(occ.empty_grid(spec, device=dev), model,
                               S.Scan(*(x[:80] for x in scans)), poses[:80])
    return model, scans, poses, grid, raycast.likelihood_field(grid)


def _pf_inputs(field_lap, n, ticks, seed=0):
    """The first cloud and each tick's inputs as the benchmark's driver
    hands them over: the increment, views into draws made in one call, the
    scan and its mask."""
    from laser_slam_tpu_torch.localization import particle_filter as pf

    model, scans, gt, _, _ = field_lap
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    xy = torch.randn(ticks, n, 2, generator=g, device="cuda")
    th = torch.randn(ticks, n, generator=g, device="cuda")
    u = torch.rand(ticks, generator=g, device="cuda")
    start = pf.init_from_noise(gt[80], torch.randn(n, 2, generator=g, device="cuda"),
                               torch.randn(n, generator=g, device="cuda"))
    steps = [(se2.relative(gt[t - 1], gt[t]), xy[k], th[k], scans.ranges[t],
              ~scans.bad[t] & (scans.ranges[t] < model.max_range), u[k])
             for k, t in enumerate(range(81, 81 + ticks))]
    return start, steps


def _pf_tick(pf, field_lap, state, step):
    _, _, _, grid, field = field_lap
    rel, xy, th, ranges, valid, u = step
    state = pf.predict_with_noise(state, rel, xy, th, 0.05, 0.03)
    state = pf.update_field(state, field, grid, field_lap[0], ranges, valid)
    state = pf.maybe_resample_at(state, u)
    return state, pf.estimate(state)


@pytest.fixture
def pf_graphs():
    """The phases' graph cache, empty, and the registry on and empty."""
    from laser_slam_tpu_torch.localization import particle_filter as pf

    pf.GRAPHS.clear()
    profiler.disable()
    profiler.reset()
    profiler.enable()
    yield pf
    profiler.disable()
    profiler.reset()
    pf.GRAPHS.clear()


def _graph_counts():
    counts = profiler.counts()
    return counts.get("pf.graph_captures", 0), counts.get("pf.graph_replays", 0)


def test_pf_graphs_are_the_eager_phases_bit_for_bit(field_lap, pf_graphs):
    """A lap of 79 ticks at 4096 particles and 361 beams: each graphed
    phase's output equals its eager body's on the same inputs bit for bit,
    and the lap's estimates equal the benchmark's frozen eager copy of the
    filter; captures 4, replays 4 x (ticks - 1)."""
    from benchmark.reference.slam.localization import particle_filter as frozen

    pf = pf_graphs
    model, _, _, grid, field = field_lap
    state, steps = _pf_inputs(field_lap, 4096, 79)
    start, ests, resampled = state, [], 0
    for rel, xy, th, ranges, valid, u in steps:
        moved = pf.predict_with_noise(state, rel, xy, th, 0.05, 0.03)
        assert torch.equal(moved.poses, pf._predicted(state.poses, rel, xy, th, 0.05, 0.03))
        assert moved.log_w is state.log_w
        weighted = pf.update_field(moved, field, grid, model, ranges, valid)
        assert torch.equal(weighted.log_w, pf._field_weights(field, grid.spec, model, moved.poses,
                                                             moved.log_w, ranges, valid))
        assert weighted.poses is moved.poses
        state = pf.maybe_resample_at(weighted, u)
        want = pf._maybe_resampled(weighted.poses, weighted.log_w, u)
        assert torch.equal(state.poses, want[0]) and torch.equal(state.log_w, want[1])
        ests.append(pf.estimate(state))
        assert torch.equal(ests[-1], pf._estimated(state.poses, state.log_w, pf.TOP_K))
        resampled += bool(torch.all(state.log_w == state.log_w[0]))
    assert 0 < resampled < len(steps)               # both branches of the select ran
    assert _graph_counts() == (4, 4 * (len(steps) - 1))
    eager = start
    for k, step in enumerate(steps):
        eager, est = _pf_tick(frozen, field_lap, eager, step)
        assert torch.equal(est, ests[k]), k


def test_pf_graph_outputs_never_change_afterwards(field_lap, pf_graphs):
    """A state and an estimate handed back by replays are the caller's: 10
    more ticks leave them as they were."""
    state, steps = _pf_inputs(field_lap, 4096, 16)
    for step in steps[:5]:
        state, est = _pf_tick(pf_graphs, field_lap, state, step)
    kept = (state.poses.clone(), state.log_w.clone(), est.clone())
    held = (state.poses, state.log_w, est)
    later = state
    for step in steps[5:15]:
        later, _ = _pf_tick(pf_graphs, field_lap, later, step)
    torch.cuda.synchronize()
    assert _graph_counts() == (4, 4 * 14)
    assert all(torch.equal(a, b) for a, b in zip(held, kept))


def test_pf_graphs_capture_again_for_a_new_cloud_or_field(field_lap, pf_graphs):
    """Another particle count captures each phase once more after its
    warm-up, and so does a second field tensor for the update; a new lap's
    tensors of the same shapes replay; the cache keeps at most its bound
    a phase over many cloud sizes."""
    pf = pf_graphs
    model, _, _, grid, field = field_lap
    for n, captures in ((4096, 4), (1024, 8)):
        for lap in range(2):                        # the second lap: new draws, same shapes
            state, steps = _pf_inputs(field_lap, n, 3, seed=lap)
            for step in steps:
                state, _ = _pf_tick(pf, field_lap, state, step)
        assert _graph_counts()[0] == captures
    other = field.clone()
    rel, xy, th, ranges, valid, u = steps[0]
    for _ in range(3):
        pf.update_field(state, other, grid, model, ranges, valid)
    assert _graph_counts()[0] == 9
    for n in (64, 128, 256, 512, 2048, 3000):
        state, steps = _pf_inputs(field_lap, n, 2)
        for step in steps:
            state, _ = _pf_tick(pf, field_lap, state, step)
    held = pf.GRAPHS._graphs
    assert set(held) == {pf._predicted, pf._field_weights, pf._maybe_resampled, pf._estimated}
    assert all(len(keys) <= cuda_graphs.PER_FUNCTION for keys in held.values())
    pf.GRAPHS.clear()
    assert pf.GRAPHS._graphs == {}


def test_pf_float_uniform_and_grad_run_eagerly(field_lap, pf_graphs):
    """A Python-float ``u`` and poses that require grad take the eager
    path: nothing captured or replayed, the results the eager bodies'."""
    pf = pf_graphs
    state, steps = _pf_inputs(field_lap, 4096, 4)
    for step in steps:
        state, _ = _pf_tick(pf, field_lap, state, step)
    before = _graph_counts()
    for u in (0.25, 0.75):
        got = pf.maybe_resample_at(state, u)
        want = pf._maybe_resampled(state.poses, state.log_w, u)
        assert torch.equal(got.poses, want[0]) and torch.equal(got.log_w, want[1])
    graded = pf.ParticleState(state.poses.clone().requires_grad_(), state.log_w)
    est = pf.estimate(graded)
    assert est.requires_grad
    assert torch.equal(est.detach(), pf._estimated(state.poses, state.log_w, pf.TOP_K))
    assert _graph_counts() == before


def test_pf_graphs_from_two_threads_are_each_calls_own(field_lap, pf_graphs):
    """Two host threads on the one default stream, as the online session's
    robot loop (``update_field`` and ``estimate`` each tick) and its pose
    server (``estimate``) run them: every result a replay hands back
    equals its eager body's on that call's own inputs, bit for bit."""
    import threading

    pf = pf_graphs
    model, _, _, grid, field = field_lap
    state, steps = _pf_inputs(field_lap, 4096, 24)
    states = []
    for step in steps:
        state, _ = _pf_tick(pf, field_lap, state, step)
        states.append((state, step))
    want_w = [pf._field_weights(field, grid.spec, model, s.poses, s.log_w, st[3], st[4])
              for s, st in states]
    want_e = [pf._estimated(s.poses, s.log_w, pf.TOP_K) for s, _ in states]
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    wrong, start = [], threading.Barrier(2)

    def robot():
        start.wait()
        for r in range(8):
            for k, (s, st) in enumerate(states):
                w = pf.update_field(s, field, grid, model, st[3], st[4]).log_w
                e = pf.estimate(s)
                if not (torch.equal(w, want_w[k]) and torch.equal(e, want_e[k])):
                    wrong.append(("robot", r, k))

    def server():
        start.wait()
        for r in range(16):
            for k in reversed(range(len(states))):
                if not torch.equal(pf.estimate(states[k][0]), want_e[k]):
                    wrong.append(("server", r, k))

    try:
        threads = [threading.Thread(target=robot), threading.Thread(target=server)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(before)
    assert wrong == []
    assert _graph_counts()[0] == 4


def test_pf_graph_kernels_are_credited_to_the_phase_spans(field_lap, pf_graphs, monkeypatch):
    """Under a ``torch.profiler`` window the graphs' kernels are device
    operations of the window, and ``benchmark/harness.summarize`` credits
    each ``pf.*`` range with their device time: every operation of the
    eager phases is counted, plus at most one a tensor copied in or
    cloned out (13 + 5 a tick); the ranges' device time is the eager
    phases' to within a factor of two (the same kernels; a static buffer's
    alignment may pick a wider vector load)."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness

    pf = pf_graphs
    state, steps = _pf_inputs(field_lap, 4096, 12)
    for step in steps[:3]:
        state, _ = _pf_tick(pf, field_lap, state, step)

    def window(ticks, state):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for step in ticks:
                state, est = _pf_tick(pf, field_lap, state, step)
                est.cpu()
            torch.cuda.synchronize()
        return state, harness.summarize(prof, 1.0)

    state, graphed = window(steps[3:7], state)
    assert _graph_counts() == (4, 4 * 6)
    with monkeypatch.context() as m:
        m.setattr(pf, "GRAPHS", lambda fn, *args: fn(*args))
        state, eager = window(steps[7:11], state)
    assert eager.n_ops <= graphed.n_ops <= eager.n_ops + 4 * 18, (graphed.n_ops, eager.n_ops)
    names = ("pf.predict", "pf.update", "pf.resample", "pf.estimate")
    for name in names:
        calls, seconds = graphed.range_device_s[name]
        assert calls == 4 and seconds > 0, (name, graphed.range_device_s[name])
    total = [sum(s.range_device_s[n][1] for n in names) for s in (graphed, eager)]
    assert 0.5 * total[1] < total[0] < 2.0 * total[1], total


def test_icp_matchers_on_the_card_against_the_cpu(cuda):
    """Polar ICP and PL-ICP of 64 room pairs on the card and on the CPU:
    the same fail flags; a match may settle a few mm apart where the last
    bit of ``atan2`` / ``cos`` flips a bin of the first projection, so the
    poses are held at the median (1 mm) and at the worst pair (5 cm)."""
    from laser_slam_tpu_torch.ops import icp, plicp

    model = S.LMS211
    ref, cur, rel = pairs(model, 64, 26, cuda)
    for fn in (icp.match_icp, plicp.match_plicp):
        info_card, info_cpu = {}, {}
        card = fn(model, ref, cur, info=info_card)
        host = fn(model, ref.to("cpu"), cur.to("cpu"), info=info_cpu)
        assert card.pose.device.type == "cuda"
        np.testing.assert_array_equal(card.fail.cpu().numpy(), host.fail.numpy())
        d = np.abs(card.pose.cpu().numpy() - host.pose.numpy()).max(axis=1)
        assert np.median(d) < 1e-3 and d.max() < 5e-2, (fn.__name__, np.median(d), d.max())
        assert int(info_card["iters"].max()) >= 1
        # The matches recover the synthetic motion.
        ok = ~host.fail.numpy()
        err = np.abs(host.pose.numpy()[ok, :2] - rel[ok, :2]).max(axis=1)
        assert np.median(err) < 0.02


def test_loopback_on_cuda(cuda):
    """The distributed topology folded into one process over localhost
    TCP on the card: the box loop closes, the trajectory is finite, and
    the frontend launched K1's two-pair entry once a scan."""
    import dataclasses

    from laser_slam_tpu_torch.runtime import slam, tcp_slam

    model = S.LaserModel(**synthetic_log.BOX_LOOP_MODEL)
    cfg = dataclasses.replace(slam.SlamConfig(), submap_points=256, wide_points=512, max_loops=64,
                              verify_chunk=16, n_theta=24, n_peaks=4, per_dst=6, search_xy=3.0,
                              gn_iters=10)
    before = psm_kernel.match_psm_fused.launches
    traj, loops = tcp_slam.run_loopback(model, synthetic_log.box_loop_scans(170), cfg)
    assert psm_kernel.match_psm_fused.launches - before == 169
    assert traj.shape == (170, 3) and np.isfinite(traj).all() and loops >= 1


# -- the robot application path ---------------------------------------------------

def _floor_and_scans(n):
    """The synthetic floor integrated at the ground truth of the log's
    first ``n`` scans (0.05 m, on the CPU), and those scans padded to
    LMS211."""
    from laser_slam_tpu_torch.mapping import occupancy as occ

    ranges, gt, _ = synthetic_log.synthetic_log(n_scans=n, n_whips=0)
    pad = S.pad_beams(ranges, S.LMS211.n_beams, S.LMS211.max_range + 1.0)
    spec = occ.GridSpec2D(-0.5, -0.5, 0.05, 380, 260)
    scans = pp.preprocess(torch.as_tensor(pad), S.LMS211)
    grid = occ.integrate_scans(occ.empty_grid(spec), S.LMS211, scans,
                               torch.as_tensor(gt, dtype=torch.float32))
    return grid, pad, gt.astype(np.float32)


def test_plan_path_on_the_card_matches_the_cpu(cuda):
    """A plan across the synthetic floor (through a doorway) on the card
    and on the CPU: the same cells, ``n_valid`` and ``reached`` (min and
    add are exact in float32; the cells follow the same rounding)."""
    from laser_slam_tpu_torch.mapping.occupancy import OccupancyGrid
    from laser_slam_tpu_torch.nav.planner import plan_path

    grid, _, _ = _floor_and_scans(600)
    out = {}
    for dev in ("cuda", "cpu"):
        g = OccupancyGrid(grid.log_odds.to(dev), grid.spec)
        res = plan_path(g, torch.tensor([3.5, 6.0], device=dev), torch.tensor([4.2, 9.8], device=dev))
        out[dev] = [x.cpu() for x in res]
    assert bool(out["cpu"][2]) and int(out["cpu"][3]) > 20
    for k in (0, 2, 3):
        assert torch.equal(out["cuda"][k], out["cpu"][k]), k


def test_local_map_on_the_card_matches_the_cpu(cuda):
    """200 posed scans through ``LocalMapService`` on the card and on the
    CPU: ``origin_cell`` equal; log-odds within 1e-4 (the same samples in
    the same cells — :mod:`refmath` rounds the bearings, sines, cosines and
    sample points alike on both — summed by atomic adds in another order)."""
    from laser_slam_tpu_torch.nav.local_map import LocalMapService

    _, pad, gt = _floor_and_scans(200)
    svc = {dev: LocalMapService(S.LMS211, device=dev) for dev in ("cuda", "cpu")}
    scans = pp.preprocess(torch.as_tensor(pad), S.LMS211)
    for i in range(len(gt)):
        for dev, s in svc.items():
            s.stream_in(S.Scan(*(x[i].to(dev) for x in scans)), gt[i])
    g, c = svc["cuda"].map, svc["cpu"].map
    assert g.log_odds.device.type == "cuda"
    assert torch.equal(g.origin_cell.cpu(), c.origin_cell)
    assert float((g.log_odds.cpu() - c.log_odds).abs().max()) <= 1e-4
    assert int((c.log_odds > 1.0).sum()) > 200


def test_dodge_path_on_the_card_matches_the_cpu(cuda):
    """The local dodge on 100 scans of the synthetic log, card against CPU:
    the same Milestone, bit for bit."""
    from laser_slam_tpu_torch.nav.local_planner import dodge_path

    _, pad, _ = _floor_and_scans(100)
    scans = pp.preprocess(torch.as_tensor(pad), S.LMS211)
    oks = 0
    for i in range(len(pad)):
        got = [dodge_path(S.LMS211, S.Scan(*(x[i].to(dev) for x in scans))) for dev in ("cuda", "cpu")]
        for a, b in zip(*got):
            assert torch.equal(a.cpu(), b)
        oks += bool(got[1].ok)
    assert oks > 50


def test_task_engine_runs_on_cuda_by_default(cuda):
    """Without ``device`` the task engine moves its grid to the card and
    its commands are made there."""
    from laser_slam_tpu_torch.app.task import TaskEngine, TaskState

    grid, pad, gt = _floor_and_scans(600)
    eng = TaskEngine(S.LMS211, grid)
    assert eng.grid.log_odds.device.type == "cuda"
    eng.add_goal((4.2, 9.8))
    scan = pp.preprocess(torch.as_tensor(pad[300], device="cuda")[None], S.LMS211)
    cmd = eng.step(np.array([3.5, 6.0, np.pi / 2], np.float32), S.Scan(*(x[0] for x in scan)))
    assert eng.state in (TaskState.TURNING, TaskState.TRACKING)
    assert cmd.v.device.type == "cuda"


# -- the landmark filters and parallel/ ----------------------------------------------

def test_landmark_filters_on_the_card_against_the_cpu(cuda):
    """EKF-SLAM (12 landmark slots) and a fastSLAM block (512 particles)
    stepped on the card and on the CPU with the same observations and the
    same draws (one CPU generator): EKF means and covariances agree to
    float32 round-off of the products (1e-4 after 40 steps); fastSLAM's
    poses to 1e-5 and its log-weights to 1e-3 relative before any
    resample."""
    from laser_slam_tpu_torch.fusion import slam_schemes as ss

    rng = np.random.default_rng(9)
    lms = rng.uniform(-4, 4, (12, 2)).astype(np.float32)
    ekf = {d: ss.ekfslam_init(torch.zeros(3), 12, device=d) for d in ("cpu", "cuda")}
    fast = {d: ss.fastslam_init(torch.zeros(3), 512, 12, device=d) for d in ("cpu", "cuda")}
    gen = torch.Generator().manual_seed(3)
    pose = np.zeros(3, np.float32)
    for _ in range(40):
        m = np.float32([0.1, 0.0, 0.06])
        pose = se2.np_compose(pose, m).astype(np.float32)
        noise = torch.randn(512, 3, generator=gen)
        sigma = torch.tensor([0.01, 0.01, 0.005])
        seen = rng.choice(12, 4, replace=False)
        zs = []
        for k in seen:
            d = lms[k] - pose[:2]
            zs.append(np.float32([np.hypot(*d), np.arctan2(d[1], d[0]) - pose[2]])
                      + rng.normal(0, 0.01, 2).astype(np.float32))
        for dev in ("cpu", "cuda"):
            e = ss.ekfslam_predict(ekf[dev], torch.tensor(m, device=dev), 1e-4)
            f = ss.fastslam_predict_with_noise(fast[dev], torch.tensor(m, device=dev), sigma, noise)
            for k, z in zip(seen, zs):
                zt = torch.tensor(z, device=dev)
                e = ss.ekfslam_observe(e, torch.tensor(int(k), device=dev), zt, 1e-3)
                f = ss.fastslam_observe(f, torch.tensor(int(k), device=dev), zt, 1e-3)
            ekf[dev], fast[dev] = e, f
    np.testing.assert_allclose(ekf["cuda"].mean.cpu().numpy(), ekf["cpu"].mean.numpy(), atol=1e-4)
    np.testing.assert_array_equal(ekf["cuda"].lm_valid.cpu().numpy(), ekf["cpu"].lm_valid.numpy())
    np.testing.assert_allclose(fast["cuda"].poses.cpu().numpy(), fast["cpu"].poses.numpy(), atol=1e-5)
    np.testing.assert_allclose(fast["cuda"].log_w.cpu().numpy(), fast["cpu"].log_w.numpy(), rtol=1e-3,
                               atol=1e-3)
    assert np.abs(ekf["cuda"].landmarks().cpu().numpy() - lms).max() < 0.2
    # Resample indices: a float32 cumsum on the card sums in another order
    # than the CPU's, so an index at a CDF step can differ by one.
    u0 = torch.rand((), generator=gen) / 512
    idx = []
    for d in ("cpu", "cuda"):
        tagged = fast[d]._replace(poses=torch.arange(512, device=d, dtype=torch.float32)[:, None]
                                  .expand(512, 3).contiguous())
        idx.append(ss.fastslam_resample_at(tagged, u0.to(d)).poses[:, 0].cpu().numpy())
    assert (idx[0] != idx[1]).mean() < 0.01 and np.abs(idx[0] - idx[1]).max() <= 1


@pytest.fixture(scope="module")
def nccl_mesh():
    import torch.distributed as dist

    from laser_slam_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an NCCL group)")
    mesh = make_mesh()
    yield mesh
    dist.destroy_process_group()


def test_sharded_psm_at_one_rank_is_the_kernel(cuda, nccl_mesh):
    """``sharded_batch_match(psm)`` on a one-rank NCCL group launches K1's
    batch entry once and returns its result bit for bit (the gather is a
    copy)."""
    from laser_slam_tpu_torch.parallel.distributed import sharded_batch_match

    ref, cur, rel = pairs(S.LMS211, 64, 27, cuda)
    before = psm_kernel.match_psm_fused.launches
    got = sharded_batch_match(nccl_mesh, S.LMS211, ref, cur)
    assert psm_kernel.match_psm_fused.launches == before + 1
    want = psm_kernel.match_psm_fused(S.LMS211, ref, cur)
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and torch.equal(a, b)
    with pytest.raises(ValueError, match="banded"):
        psm_kernel.match_psm_fused(S.LMS211, ref, cur, banded=True)


@pytest.mark.parametrize("v", [60, 1100])
def test_distributed_optimize_on_the_card_is_optimize(cuda, nccl_mesh, v):
    """The edge-sharded LM at one rank against ``optimize`` on the card,
    dense and CG routes: within the atomic sums' run-to-run spread (held
    at 1e-4 m; where an accept decision lies in a flat valley the two may
    take a step more or less), and with PyTorch's deterministic kernels
    the same steps and the same poses bit for bit."""
    from laser_slam_tpu_torch.graph.solve import PoseGraph, optimize
    from laser_slam_tpu_torch.parallel.distributed import distributed_optimize

    rng = np.random.default_rng(v)
    gt = np.cumsum(rng.normal(0, [0.3, 0.3, 0.1], (v, 3)), axis=0).astype(np.float32)
    i = np.concatenate([np.arange(v - 1), rng.integers(0, v // 2, v // 4)])
    j = np.concatenate([np.arange(1, v), rng.integers(v // 2, v, v // 4)])
    meas = se2.np_relative(gt[i], gt[j]).astype(np.float32) + rng.normal(0, 0.02, (len(i), 3)).astype(np.float32)
    poses = gt + rng.normal(0, 0.2, gt.shape).astype(np.float32)
    poses[0] = gt[0]
    t = lambda x, dt=None: torch.as_tensor(x, dtype=dt, device=cuda)
    g = PoseGraph(t(poses), t(np.ones(v, bool)), t(i, torch.int64), t(j, torch.int64), t(meas),
                  t(np.tile(np.eye(3, dtype=np.float32) * 20, (len(i), 1, 1))),
                  t(np.ones(len(i), bool)))
    got, chi = distributed_optimize(nccl_mesh, g, 10)
    want, want_chi = optimize(g, 10)
    np.testing.assert_allclose(got.poses.cpu().numpy(), want.poses.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(float(chi), float(want_chi), rtol=1e-4)
    info_d, info_p = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got, chi = distributed_optimize(nccl_mesh, g, 10, info=info_d)
        want, want_chi = optimize(g, 10, info=info_p)
    finally:
        torch.use_deterministic_algorithms(False)
    assert info_d == info_p and info_d["steps"] > 0
    assert torch.equal(got.poses, want.poses) and torch.equal(chi, want_chi)
