"""Each cell's run on the CPU at a small size, without the look for a card:

    python -m pytest -q -p no:cacheprovider benchmark/test_bench_cells.py

A sound run of the program's plain CPU path agrees with the reference
(``correct``); the same run with the timed path broken underneath does
not: once with an answer altered where it is produced, once with a step
that returns its state unchanged. The control (the reference in
bfloat16 in the program's place) fails at least one of the cell's
limits. The card's own runs of the control are ``benchmark/control.py``.
"""

from __future__ import annotations

import importlib
import json
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark import harness  # noqa: E402

import laser_slam_tpu_torch.localization.particle_filter as pf  # noqa: E402

torch.set_num_threads(1)

# Small enough for a test run: (scans in the log, window seconds, mix changes).
SIZES = {
    "intel_lab.odometry": (30, 0.01, {"deep_chunk": 8, "warmup_laps": 0}),
    "fr079.odometry": (30, 0.01, {"deep_chunk": 8, "warmup_laps": 0}),
    "fr079.localize": (40, 0.3, {"warmup_ticks": 2, "particles": 512}),
}


def small_cell(name: str, seed: int = 11) -> harness.Cell:
    """The cell ``<config>.<mix>`` at its test size."""
    config, traffic = name.split(".")
    w = {"name": name, "config": config, "traffic": traffic}
    n_scans, seconds, mix = SIZES[name]
    cell = harness.Cell.of(w, seed, seconds, False, device="cpu", n_scans=n_scans,
                           t_start=time.perf_counter())
    cell.mix.update(mix)
    return cell


def run_cell(name: str) -> harness.Outcome:
    cell = small_cell(name)
    return importlib.import_module(f"benchmark.drivers.{cell.mix['driver']}").run(cell)


def correct(outcome: harness.Outcome) -> bool:
    return all(c.ok for c in outcome.checks)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_sound_run_is_correct(name):
    out = run_cell(name)
    assert out.attempted > 0 and out.failed == 0
    assert correct(out), out.checks
    assert out.end_to_end["setup_s"] > 0


def _shift_poses(fn):
    def altered(*args, **kwargs):
        res = fn(*args, **kwargs)
        poses = res.poses.clone()
        poses[len(poses) // 2:, 0] += 0.05
        return res._replace(poses=poses)
    return altered


def _frozen_chain(fn):
    def frozen(*args, **kwargs):
        res = fn(*args, **kwargs)
        return res._replace(poses=torch.zeros_like(res.poses))
    return frozen


def _estimate_altered(fn):
    def altered(state, *args):
        return fn(state, *args) + torch.tensor([0.0, 0.1, 0.0])
    return altered


def _predict_unchanged(fn):
    def unchanged(state, *args, **kwargs):
        return state
    return unchanged


FAULTS = {
    ("intel_lab.odometry", "answer_altered"): ("benchmark.drivers.replay", "odometry_keyframe",
                                               _shift_poses),
    ("intel_lab.odometry", "state_unchanged"): ("benchmark.drivers.replay", "odometry_keyframe",
                                                _frozen_chain),
    ("fr079.localize", "answer_altered"): (pf, "estimate", _estimate_altered),
    ("fr079.localize", "state_unchanged"): (pf, "predict_with_noise", _predict_unchanged),
}


@pytest.mark.parametrize("case", sorted(FAULTS), ids="-".join)
def test_broken_timed_path_is_not_correct(case, monkeypatch):
    target, attr, fault = FAULTS[case]
    if isinstance(target, str):
        target = importlib.import_module(target)
    monkeypatch.setattr(target, attr, fault(getattr(target, attr)))
    assert not correct(run_cell(case[0]))


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_fails_a_limit(name):
    cell = small_cell(name)
    checks = importlib.import_module(f"benchmark.drivers.{cell.mix['driver']}").control(cell)
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("config", ["intel_lab", "fr079"])
def test_reference_lanes_follow_one_chain(config):
    """Pass 1 as lanes, each started from the scans alone and settled over
    its overlap, gives the one chain's steps and flags."""
    from benchmark import traffic
    from benchmark.reference import replay as ref_replay

    cfg = harness.load_json(HERE / "configs" / f"{config}.json")
    log = traffic.make_log(cfg, 2**31 + 5, n_scans=90, trajectory_seed=1)
    one = ref_replay.replay(log, "cpu", deep_chunk=8, lanes=None)
    lanes = ref_replay.replay(log, "cpu", deep_chunk=8, lanes=(20, 20))
    assert (lanes["flags"] == one["flags"]).all()
    assert lanes["iterations"] == one["iterations"]
    gap = harness.pose_gaps(harness.np_relative(lanes["poses"][:-1], lanes["poses"][1:]),
                            harness.np_relative(one["poses"][:-1], one["poses"][1:]))
    assert gap[0].max() < 1e-4 and gap[1].max() < 1e-4


@pytest.mark.cuda
def test_control_fails_a_limit_on_the_card_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.Cell.of(w, 12345, bench["run_seconds"], False)
        checks = importlib.import_module(f"benchmark.drivers.{cell.mix['driver']}").control(cell)
        assert not all(c.ok for c in checks), (w["name"], checks)
