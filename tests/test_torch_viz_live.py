"""The port's live viewer (``viz/live``) and ``cli view``, headless:
``tests/test_viz_live.py`` on the port, the scan projection against the
JAX package's, and ``cli view`` on a short log written by
``tools/synthetic_log.py`` (no bundled log needed). Host code: equality
is exact."""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from laser_slam_tpu.core.scan import LMS211 as JLMS211
from laser_slam_tpu.viz import live as jlive
from laser_slam_tpu_torch import cli as tcli
from laser_slam_tpu_torch.core.scan import LMS211
from laser_slam_tpu_torch.mapping.occupancy import GridSpec2D, OccupancyGrid
from laser_slam_tpu_torch.viz.live import LiveViewer, replay_log, scan_to_world

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402


def test_scan_to_world_projects_valid_beams():
    model = LMS211
    r = np.full(model.n_beams, model.max_range + 10, np.float32)
    mid = model.n_beams // 2  # bearing 0 for the symmetric LMS211 fan
    r[mid] = 2.0
    pts = scan_to_world(model, r, np.asarray([1.0, 1.0, 0.0], np.float32))
    assert pts.shape == (1, 2)
    assert np.allclose(pts[0], [3.0, 1.0], atol=0.02)


def test_scan_to_world_matches_jax():
    rng = np.random.default_rng(0)
    r = rng.uniform(0.0, 60.0, LMS211.n_beams).astype(np.float32)
    pose = np.asarray([1.5, -0.5, 2.0], np.float32)
    np.testing.assert_array_equal(scan_to_world(LMS211, r, pose),
                                  jlive.scan_to_world(JLMS211, r, pose))


def test_viewer_updates_and_captures(tmp_path):
    v = LiveViewer()
    poses = np.cumsum(np.full((20, 3), 0.1, np.float32), axis=0)
    scan = np.random.default_rng(0).uniform(-2, 2, (50, 2)).astype(np.float32)
    v.update(poses=poses, scan_xy=scan, particles=np.zeros((30, 3)), gt=poses * 0.9)
    frame = v.capture()
    assert frame.ndim == 3 and frame.shape[2] == 3
    v.update(poses=poses * 2.0, scan_xy=scan + 1.0)
    v.capture()

    png = tmp_path / "frame.png"
    gif = tmp_path / "anim.gif"
    v.save_frame(str(png))
    v.save_video(str(gif), fps=5)
    assert png.stat().st_size > 1000
    assert gif.stat().st_size > 1000
    v.close()


def test_viewer_with_map_underlay():
    spec = GridSpec2D(-2.0, -2.0, 0.1, 40, 40)
    lo = torch.zeros(40, 40)
    lo[20, :] = 4.0
    v = LiveViewer()
    v.update(grid=OccupancyGrid(lo, spec), poses=np.zeros((1, 3), np.float32))
    frame = v.capture()
    assert frame.size > 0
    v.set_map(OccupancyGrid(-lo, spec))   # the underlay is replaced in place
    v.close()


@pytest.fixture(scope="module")
def short_log(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("view") / "synthetic.log")
    synthetic_log.write_carmen(path, *synthetic_log.synthetic_log(n_scans=60, n_whips=0))
    return path


def test_cli_view_writes_artifacts(tmp_path, short_log):
    frame, gif = tmp_path / "view.png", tmp_path / "view.gif"
    v = tcli.main(["view", short_log, "--device", "cpu", "--stride", "30",
                   "--frame", str(frame), "--out", str(gif)])
    assert frame.stat().st_size > 1000
    assert gif.stat().st_size > 1000
    assert len(v._frames) == 2          # scans 0 and 30


def test_cli_view_replays_a_trajectory_file(tmp_path, short_log):
    """``--traj`` longer than the log is clamped to its scans, and the
    ground truth is drawn beside it."""
    traj = tmp_path / "traj.txt"
    _, gt, _ = synthetic_log.synthetic_log(n_scans=60, n_whips=0)
    np.savetxt(traj, np.concatenate([gt, gt[:20]]) + 0.1, fmt="%.6f")
    frame = tmp_path / "traj.png"
    v = tcli.main(["view", short_log, "--device", "cpu", "--stride", "59", "--traj", str(traj),
                   "--frame", str(frame)])
    assert frame.stat().st_size > 1000
    xs, _ = v._traj.get_data()
    assert len(xs) == 60 and np.allclose(xs[-1], gt[59, 0] + 0.1, atol=1e-5)
    assert len(v._gt.get_data()[0]) == 60


def test_replay_log_with_grid(tmp_path):
    from laser_slam_tpu_torch.io.carmen import read_carmen

    path = str(tmp_path / "l.log")
    synthetic_log.write_carmen(path, *synthetic_log.synthetic_log(n_scans=10, n_whips=0))
    log = read_carmen(path)
    grid = OccupancyGrid(torch.zeros(30, 30), GridSpec2D(-1.0, -1.0, 0.5, 30, 30))
    v = replay_log(log, log.gt_pose, stride=5, grid=grid)
    assert v._img is not None
    v.close()
