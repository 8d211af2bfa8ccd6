"""The port's accuracy lane: ``tests/test_accuracy.py``'s full-log bounds
on the PyTorch port, run on ``cuda``.

Per bundled CARMEN log (at the repo's reference-data location,
``chip_smoke.REFERENCE_DATA``, as in ``tests/conftest.py``): the port's keyframe odometry ATE under the
recorded bound (the JAX package's, ``diag/r5_*.json``, × 1.10) and below
the reference implementation's own odometry
(``baselines/reference.json``); ``slam_offline`` at ``SlamConfig()``
beating its odometry and under the recorded SLAM bound (× 1.35); the
wrong fraction of the loops the final solve used under the recorded one
× 1.5. Wrong loops are counted by ``eval/diagnostics.classify_loops``
(0.5 m or 0.2 rad from the ground truth), which also checks rotation;
the JAX lane checks translation only.

Marked ``accuracy`` (not in the default suite); skips without the logs
or without a CUDA device. It imports no jax::

    python -m pytest --noconftest -p no:cacheprovider -m accuracy tests/test_torch_accuracy.py
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.accuracy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import REFERENCE_DATA  # noqa: E402

BASELINES = os.path.join(REPO, "baselines", "reference.json")

# The JAX lane's recorded values and bounds (tests/test_accuracy.py:48-74).
RECORDED_ODO_ATE = {"intel-lab": 8.97, "fr079": 3.00, "mit-cscail": 1.81}
RECORDED_SLAM_ATE = {"intel-lab": 0.86, "fr079": 0.21, "mit-cscail": 1.18}
SLAM_BOUND = {log: round(v * 1.35, 2) for log, v in RECORDED_SLAM_ATE.items()}
RECORDED_WRONG_USED = {"intel-lab": 0.048, "fr079": 0.006, "mit-cscail": 0.181}
WRONG_USED_BOUND = {log: max(round(v * 1.5, 3), 0.05) for log, v in RECORDED_WRONG_USED.items()}


def _log_on_cuda(log_name):
    path = os.path.join(REFERENCE_DATA, f"{log_name}.log")
    if not os.path.exists(path):
        pytest.skip("reference data not available")
    if not torch.cuda.is_available():
        pytest.skip("the port's accuracy lane runs on a CUDA device")
    from laser_slam_tpu_torch.io.carmen import read_carmen

    return read_carmen(path), torch.device("cuda")


def _reference_ate(log_name: str) -> float:
    if not os.path.exists(BASELINES):
        pytest.skip("baselines/reference.json not generated")
    with open(BASELINES) as f:
        ref = json.load(f)
    if log_name not in ref["logs"]:
        pytest.skip(f"no reference baseline for {log_name}")
    return float(ref["logs"][log_name]["ate_rmse_m"])


@pytest.mark.parametrize("log_name", list(RECORDED_ODO_ATE))
def test_odometry_beats_reference_and_recorded_bound(log_name):
    from laser_slam_tpu_torch.eval.metrics import ate
    from laser_slam_tpu_torch.ops.odometry import odometry_keyframe
    from laser_slam_tpu_torch.ops.preprocess import preprocess

    log, dev = _log_on_cuda(log_name)
    scans = preprocess(torch.as_tensor(log.ranges, device=dev), log.model)
    odo = odometry_keyframe(log.model, scans, timestamps=log.timestamps)
    a = float(ate(odo.poses, torch.as_tensor(log.gt_pose, device=dev)).rmse)
    ref_a = _reference_ate(log_name)
    assert a < ref_a, f"{log_name}: odometry {a:.2f} vs reference {ref_a:.2f}"
    bound = RECORDED_ODO_ATE[log_name] * 1.10
    assert a < bound, f"{log_name}: odometry ATE regressed: {a:.2f} > {bound:.2f}"


@pytest.mark.parametrize("log_name", list(RECORDED_SLAM_ATE))
def test_slam_beats_odometry_and_recorded_bound(log_name):
    from laser_slam_tpu_torch.eval.diagnostics import classify_loops
    from laser_slam_tpu_torch.eval.metrics import ate
    from laser_slam_tpu_torch.runtime.slam import SlamConfig, slam_offline

    log, dev = _log_on_cuda(log_name)
    d: dict = {}
    res = slam_offline(log.model, log.ranges, SlamConfig(), diag=d,
                       timestamps=log.timestamps, device=dev)
    gt = torch.as_tensor(log.gt_pose, device=dev)
    a_odo = float(ate(res.odo_poses, gt).rmse)
    a_slam = float(ate(res.poses, gt).rmse)
    assert a_slam < a_odo, f"{log_name}: SLAM ({a_slam:.2f}) must beat odometry ({a_odo:.2f})"
    bound = SLAM_BOUND[log_name]
    assert a_slam < bound, f"{log_name}: SLAM ATE regressed: {a_slam:.2f} > {bound:.2f}"
    if log_name == "intel-lab":
        assert int(res.n_loops) >= 50
        assert a_slam < 2.0

    bank = d["bank"]
    used = bank["used"] & bank["act"]
    gt_anchor = log.gt_pose[res.anchor_idx.cpu().numpy()]
    rep = classify_loops(bank["src"], bank["dst"], bank["rel"], used, gt_anchor)
    frac_wrong = 1.0 - rep.n_correct / max(rep.n, 1)
    assert rep.n >= 20, f"{log_name}: solve used only {rep.n} loops"
    assert frac_wrong <= WRONG_USED_BOUND[log_name], (
        f"{log_name}: wrong-loop fraction in the solved set {frac_wrong:.3f} > "
        f"{WRONG_USED_BOUND[log_name]}")
    assert np.isfinite(res.poses.cpu().numpy()).all()
