"""The port's odometry slice end to end against the JAX package: a small
synthetic CARMEN log through ``laser_slam_tpu.cli odometry`` and
``laser_slam_tpu_torch.cli odometry --device cpu``; ATE/RPE; the
occupancy-grid integration; the port importing without jax.

As in tests/test_torch_odometry.py, the trajectories are compared with
JAX's PSM matcher injected into the port (float round-off, atol 1e-3)
and end to end (per-pair last-bit stops, atol 2e-2).
"""

import argparse
import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on the CPU; one intra-op thread each
# keeps torch's thread pools from oversubscribing it.
torch.set_num_threads(1)

from laser_slam_tpu import cli as jcli
from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.eval import metrics as jmetrics
from laser_slam_tpu.io.carmen import read_carmen as jread
from laser_slam_tpu.mapping import occupancy as jocc
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu.ops import psm as jpsm
import laser_slam_tpu_torch
from laser_slam_tpu_torch import cli as tcli
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.eval import metrics as tmetrics
from laser_slam_tpu_torch.mapping import occupancy as tocc
from laser_slam_tpu_torch.ops import odometry as todo
from laser_slam_tpu_torch.ops import psm as tpsm

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import synthetic_log  # noqa: E402

POSE_ATOL = 1e-3
END_TO_END_ATOL = 2e-2
METRIC_ATOL = 1e-5        # float32 reductions
LOG_ODDS_ATOL = 1e-4      # order of the scatter-add sums


@pytest.fixture(scope="module")
def small_log(tmp_path_factory):
    """60 scans of the synthetic floor plan (no whip, so no step needs the
    exhaustive re-match)."""
    path = str(tmp_path_factory.mktemp("slice") / "synthetic.log")
    synthetic_log.write_carmen(path, *synthetic_log.synthetic_log(n_scans=60, n_whips=0))
    return path


@pytest.fixture(scope="module")
def jax_traj(small_log, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax") / "traj.txt")
    jcli.cmd_odometry(argparse.Namespace(log=small_log, scans=None, pairwise=False, out=out))
    return np.loadtxt(out)


def _jax_psm_for(model):
    match = jax.jit(jax.vmap(lambda a, b, p: jpsm.match_psm(model, a, b, p)))

    def run(_model, ref, cur, init_pose=None):
        to_j = lambda s: jscan.Scan(*(jnp.asarray(x.numpy()) for x in s))
        r = match(to_j(ref), to_j(cur), jnp.asarray(init_pose.numpy()))
        return tpsm.MatchResult(*(torch.from_numpy(np.array(x)) for x in r))

    return run


@pytest.mark.parametrize("inject", [True, False])
def test_cli_odometry_matches_jax(small_log, jax_traj, tmp_path, inject, monkeypatch, capsys):
    log = jread(small_log)
    if inject:
        monkeypatch.setattr(todo, "match_psm_fused", _jax_psm_for(log.model))
    out, png = str(tmp_path / "traj.txt"), str(tmp_path / "map.png")
    run = tcli.main(["odometry", small_log, "--device", "cpu", "--out", out, "--map", png])
    printed = capsys.readouterr().out
    got = np.loadtxt(out)
    atol = POSE_ATOL if inject else END_TO_END_ATOL
    assert got.shape == jax_traj.shape == (60, 3)
    np.testing.assert_allclose(got, jax_traj, atol=atol)
    assert not run.result.rematched.any()
    # The same ATE, and the same lines as the JAX CLI prints.
    want = jmetrics.ate(jnp.asarray(jax_traj), jnp.asarray(log.gt_pose))
    assert abs(float(run.ate.rmse) - float(want.rmse)) < atol
    assert "60 scans in " in printed and f"ATE rmse={float(run.ate.rmse):.3f}m" in printed
    assert f"trajectory -> {out}" in printed and open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def test_metrics_match_jax(small_log, jax_traj):
    gt = jread(small_log).gt_pose
    est = jax_traj.astype(np.float32)
    want = jmetrics.ate(jnp.asarray(est), jnp.asarray(gt))
    got = tmetrics.ate(torch.from_numpy(est), torch.from_numpy(gt))
    # 60 poses, an even count: the median is the mean of the two middle
    # errors (torch.median would give the lower one); then 59, an odd one.
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), atol=METRIC_ATOL)
    got_odd = tmetrics.ate(torch.from_numpy(est[:59]), torch.from_numpy(gt[:59]))
    want_odd = jmetrics.ate(jnp.asarray(est[:59]), jnp.asarray(gt[:59]))
    np.testing.assert_allclose(float(got_odd.median), float(want_odd.median), atol=METRIC_ATOL)
    for a, b in zip(tmetrics.rpe(torch.from_numpy(est), torch.from_numpy(gt), 3),
                    jmetrics.rpe(jnp.asarray(est), jnp.asarray(gt), 3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=METRIC_ATOL)
    rot, t = tmetrics.align_se2(torch.from_numpy(est[:, :2]), torch.from_numpy(gt[:, :2]))
    jrot, jt = jmetrics.align_se2(jnp.asarray(est[:, :2]), jnp.asarray(gt[:, :2]))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), atol=METRIC_ATOL)


def test_integrate_scans_matches_jax(small_log):
    log = jread(small_log)
    model = log.model
    poses = log.gt_pose.astype(np.float32)
    spec = jocc.spec_for_trajectory(poses, 12.0, 0.05)
    js = jpp.preprocess(jnp.asarray(log.ranges), model)
    want = jax.jit(lambda g, s, p: jocc.integrate_scans(g, model, s, p))(
        jocc.empty_grid(spec), js, jnp.asarray(poses))
    tspec = tocc.spec_for_trajectory(poses, 12.0, 0.05)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(spec)
    start = interop.grid_from_numpy(np.zeros((spec.height, spec.width)), dataclasses.asdict(spec))
    got = tocc.integrate_scans(start, interop.model_from_fields(dataclasses.asdict(model)),
                               interop.scan_from_numpy(*(np.asarray(x) for x in js)),
                               torch.from_numpy(poses))
    lo, fields = interop.grid_to_numpy(got)
    want = np.asarray(want.log_odds)
    assert fields == dataclasses.asdict(spec)
    # Of the ~1.4 M endpoints and free-space samples, a handful lie within
    # a float32 last bit of a cell edge, where XLA's and PyTorch's cos/sin
    # put them in neighbouring cells: the pair of cells then differs by
    # that sample's increment (about ten cells of ~50,000 here). Every
    # other cell agrees to the order of the sums, and no mass is lost.
    touched = want != 0
    off = np.abs(lo - want) > LOG_ODDS_ATOL
    assert off.sum() <= touched.sum() // 2000, off.sum()
    np.testing.assert_allclose(lo.sum(), want.sum(), rtol=1e-5)
    assert (lo > 0).sum() > 1000 and (lo < 0).sum() > 10000


def test_draw_writes_the_map(small_log, tmp_path):
    png = str(tmp_path / "gt_map.png")
    grid = tcli.main(["draw", small_log, "--device", "cpu", "--out", png, "--resolution", "0.1"])
    from PIL import Image

    img = np.asarray(Image.open(png))
    assert img.shape == (grid.spec.height, grid.spec.width, 3)
    assert (img[..., 0] == 220).sum() >= 1 and (img < 50).all(-1).sum() > 100


def test_port_imports_without_jax():
    """Every module of the port (and chip_smoke.py) imports with jax made
    unimportable, the CLI builds its parser (the ``slam`` subcommand reads
    ``SlamConfig``'s defaults), and no port source names jax."""
    names = [m.name for m in pkgutil.walk_packages(
        laser_slam_tpu_torch.__path__, "laser_slam_tpu_torch.")]
    assert {"laser_slam_tpu_torch." + n for n in (
        "graph.submap", "graph.place_recognition", "graph.loop_closure", "graph.solve",
        "runtime.slam", "eval.diagnostics", "interop", "cli",
        "utils.checkpoint", "utils.timestamp", "utils.profiling", "core.device",
        "mapping.incremental", "fusion.ukf", "runtime.backend", "runtime.online",
        "runtime.facade", "localization.raycast", "localization.particle_filter",
        "nav.controller", "native.api", "runtime.tcp_slam", "ops.icp", "ops.plicp",
        "features.detector", "features.descriptor", "features.ransac",
        "nav.planner", "nav.local_map", "nav.local_planner", "nav.trajectory", "core.refmath",
        "app.config", "app.logfile", "app.monitor", "app.beacon", "app.serial_ctrl", "app.portal",
        "app.task", "app.mission", "app.robot")} <= set(names)
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['laser_slam_tpu'] = None\n"
        f"import importlib\nfor n in {names!r} + ['chip_smoke']:\n    importlib.import_module(n)\n"
        "from laser_slam_tpu_torch import cli\n"
        "for sub in ('slam', 'odometry', 'draw', 'localize', 'eval', 'serve', 'client'):\n"
        "    try:\n        cli.main([sub, '--help'])\n"
        "    except SystemExit as e:\n        assert e.code == 0\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(names) >= 71
    for path in [*(ROOT / "laser_slam_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
                 ROOT / "tools" / "synthetic_log.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "laser_slam_tpu." not in text.replace("laser_slam_tpu_torch", ""), path


def test_cli_defaults_to_cuda_and_raises_without_one(small_log, monkeypatch):
    """Without ``--device`` the CLI runs on ``cuda``; where there is no
    CUDA device it raises and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["odometry", small_log])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["draw", small_log, "--device", "cuda:0"])
    assert tcli._device("cpu") == torch.device("cpu")
