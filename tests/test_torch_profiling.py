"""The program's spans and counters (``utils/profiling``): off, the
registry records nothing and enters no ``record_function``; under
``enable()`` it records without a range; under a ``torch.profiler``
window it records and each span is a range of the profiler's timeline.
Held on ``odometry_keyframe`` (its phases and pass 2's padding counters),
the particle filter's four phases and the names of their graph counters,
the ray-cast + ICP update's spans and counters, the global
relocalization's span and counters, and the correlative
search's ``h2`` range, on the CPU."""

import math
import os
import sys
import threading
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

# pytest-xdist runs several workers on the CPU; one intra-op thread each
# keeps torch's thread pools from oversubscribing it.
torch.set_num_threads(1)

from laser_slam_tpu_torch.core.scan import LMS211
from laser_slam_tpu_torch.localization import particle_filter as pf
from laser_slam_tpu_torch.localization.raycast import likelihood_field
from laser_slam_tpu_torch.mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
from laser_slam_tpu_torch.ops.correlative import match_correlative
from laser_slam_tpu_torch.ops.odometry import odometry_keyframe
from laser_slam_tpu_torch.ops.preprocess import preprocess
from laser_slam_tpu_torch.utils.profiling import Profiler, profiler

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

ODOMETRY_SPANS = ("odometry.keyframe", "odometry.chain", "odometry.flags_fetch",
                  "odometry.rematch", "odometry.rematch_fetch", "odometry.rechain")
PF_SPANS = ("pf.predict", "pf.update", "pf.resample", "pf.estimate")
PF_GRAPH_COUNTERS = ("pf.graph_captures", "pf.graph_replays")
# ``update_raycast_icp``: the update, its march and its ICP chunk loop.
PF_ICP_SPANS = ("pf.update", "pf.raycast", "pf.icp")
PF_ICP_COUNTERS = ("pf.icp_pairs", "pf.icp_chunks", "pf.raycast_rays", "pf.raycast_chunks")
# ``global_relocalize_at``: the relocalization's span and its counters;
# ``free_cells`` counts the table's length.
PF_RELOC_COUNTERS = ("pf.reloc_samples", "pf.reloc_kept")
# ``match_icp_points``' search: one kernel launch a search on CUDA float32
# tensors, none on the CPU.
ICP_KERNEL_COUNTERS = ("icp.nearest_two_launches",)


def short_log(n=40, whip_at=20, seed=40):
    """Ground-truth poses ``[n, 3]`` (5 cm / 2° steps, a 120° turn in
    place at ``whip_at`` behind a 12× dt gap, so that pass 2 runs),
    timestamps and the preprocessed scans."""
    rng = np.random.default_rng(seed)
    poses, ts = [np.asarray([-1.0, 1.0, -1.0])], [0.0]
    for i in range(1, n):
        x, y, th = poses[-1]
        if i == whip_at:
            poses.append(np.asarray([x, y, th + np.radians(120.0)]))
            ts.append(ts[-1] + 1.2)
            continue
        th = th + np.radians(2.0) + rng.normal(0, 0.003)
        poses.append(np.asarray([x + 0.05 * np.cos(th), y + 0.05 * np.sin(th), th]))
        ts.append(ts[-1] + 0.1 + rng.normal(0, 0.002))
    poses = np.stack(poses)
    r = synthetic_log.ray_cast(synthetic_log.room_walls(), poses,
                               LMS211.bearings(torch.float64).numpy(), LMS211.max_range)
    r = np.where(r <= LMS211.max_range, r + rng.normal(0, 0.01, r.shape), r)
    return poses, np.asarray(ts), preprocess(torch.from_numpy(r.astype(np.float32)), LMS211)


@pytest.fixture(scope="module")
def log():
    return short_log()


@pytest.fixture
def registry():
    """The program's registry, off and empty before and after the test."""
    profiler.disable()
    profiler.reset()
    yield profiler
    profiler.disable()
    profiler.reset()


@pytest.fixture
def ranges_entered(monkeypatch):
    """Names of every ``record_function`` the registry opens."""
    names = []
    real = torch.profiler.record_function

    def spy(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    return names


def pf_tick(log, n=64, ticks=3):
    """``ticks`` particle-filter ticks over the log's map, as the filter
    runs them: predict, field update, resample, estimate."""
    poses, _, scans = log
    gt = torch.from_numpy(poses.astype(np.float32))
    grid = integrate_scans(empty_grid(spec_for_trajectory(poses, 8.0, 0.1)), LMS211, scans, gt)
    field = likelihood_field(grid)
    g = torch.Generator().manual_seed(3)
    state = pf.init_from_noise(gt[0], torch.randn(n, 2, generator=g), torch.randn(n, generator=g))
    for t in range(1, ticks + 1):
        valid = ~scans.bad[t] & (scans.ranges[t] < LMS211.max_range)
        rel = torch.tensor([0.05, 0.0, 0.03])
        state = pf.predict_with_noise(state, rel, torch.randn(n, 2, generator=g),
                                      torch.randn(n, generator=g), 0.05, 0.03)
        state = pf.update_field(state, field, grid, LMS211, scans.ranges[t], valid)
        state = pf.maybe_resample_at(state, 0.5)
        pf.estimate(state)


def test_off_records_nothing_and_enters_no_range(registry, ranges_entered, log):
    _, ts, scans = log
    assert registry.trace("a") is registry.trace("b")        # one shared no-op
    with registry.trace("a"):
        registry.count("c", 5)
    odometry_keyframe(LMS211, scans, deep_chunk=8, timestamps=ts, chain="steps")
    pf_tick(log, ticks=1)
    assert registry.report() == {} and registry.counts() == {}
    assert ranges_entered == []


def test_off_span_is_cheap():
    prof = Profiler()

    def span():
        with prof.trace("x"):
            pass

    seconds = min(timeit.repeat(span, number=20_000, repeat=5)) / 20_000
    assert seconds < 5e-6        # about 0.5 µs on a desktop CPU


def test_enabled_records_without_a_window(registry, ranges_entered):
    registry.enable()
    for k in range(3):
        with registry.trace("outer"):
            with registry.trace("inner"):
                registry.count("things", k)
    registry.count("things")
    rep = registry.report()
    assert rep["outer"]["count"] == 3 and rep["inner"]["count"] == 3
    assert rep["outer"]["total"] >= rep["inner"]["total"] > 0
    assert rep["outer"]["max"] <= rep["outer"]["total"]
    assert rep["outer"]["mean"] == pytest.approx(rep["outer"]["total"] / 3)
    assert registry.counts() == {"things": 4}
    assert ranges_entered == []
    registry.reset()
    assert registry.report() == {} and registry.counts() == {}


def test_aggregates_hold_constant_memory(registry):
    registry.enable()
    for _ in range(1000):
        registry.record("step", 0.25)
    assert registry._spans == {"step": [1000, 250.0, 0.25]}


def test_threads_lose_no_update(registry):
    """Spans and counts from more threads than cores, switching often."""
    registry.enable()
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 2000

    def work():
        for _ in range(per_thread):
            with registry.trace("span"):
                registry.count("things")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert registry.counts() == {"things": n_threads * per_thread}
    assert registry.report()["span"]["count"] == n_threads * per_thread


def test_window_records_and_nests_the_odometry_spans(registry, log):
    _, ts, scans = log
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = odometry_keyframe(LMS211, scans, deep_chunk=3, timestamps=ts, chain="steps")
    assert not registry.enabled
    rep, counts = registry.report(), registry.counts()
    assert all(rep[n]["count"] == 1 for n in ODOMETRY_SPANS), rep
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    for name in ODOMETRY_SPANS + ("h2_score_volume_conv", "h1_nearest_two"):
        assert name in events, name
    (outer,), (inner,) = events["odometry.keyframe"], events["odometry.rematch"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert outer.thread == inner.thread

    steps = int(res.rematched.sum())
    assert steps == 4           # the whip and its neighbours: two chunks, one padded
    assert counts == {"odometry.rematch_steps": 4, "odometry.rematch_rows": 6}


def test_enabled_counts_rows_of_each_call(registry, log):
    _, ts, scans = log
    registry.enable()
    steps = rows = 0
    for chunk in (4, 128):
        n = int(odometry_keyframe(LMS211, scans, deep_chunk=chunk, timestamps=ts,
                                  chain="steps").rematched.sum())
        steps, rows = steps + n, rows + math.ceil(n / chunk) * chunk
    counts = registry.counts()
    assert counts == {"odometry.rematch_steps": steps, "odometry.rematch_rows": rows}
    assert registry.report()["odometry.keyframe"]["count"] == 2


def test_each_pf_span_counts_once_a_call(registry, log):
    registry.enable()
    pf_tick(log, ticks=3)
    rep = registry.report()
    assert {n: rep[n]["count"] for n in PF_SPANS} == dict.fromkeys(PF_SPANS, 3)
    registry.reset()
    state = pf.init_from_noise(torch.zeros(3), torch.zeros(16, 2), torch.zeros(16))
    pf.predict(state, torch.zeros(3), torch.Generator().manual_seed(0))
    assert registry.report()["pf.predict"]["count"] == 1


def test_pf_graph_counters_keep_their_names_and_stay_off_the_cpu(registry, log):
    """The phases' graph counters (captures, replays) have fixed names;
    on CPU tensors no phase replays a graph, so neither counts."""
    assert pf.GRAPHS.counters == PF_GRAPH_COUNTERS
    registry.enable()
    pf_tick(log, ticks=3)
    assert not set(registry.counts()) & set(PF_GRAPH_COUNTERS)
    assert registry.report()["pf.update"]["count"] == 3


@pytest.mark.parametrize("chunk", [None, 5])
def test_raycast_icp_spans_nest_and_counters_count(registry, log, chunk):
    """Off, ``update_raycast_icp`` records nothing; under a window each of
    its spans is one range, ``pf.raycast`` and ``pf.icp`` inside
    ``pf.update`` and the ten ``h1_nearest_two`` searches inside
    ``pf.icp``; its counters add ``P · N`` rays in one march chunk and
    ``P · N² · 10`` pairs in ``⌈P / chunk⌉`` search chunks, and on the
    CPU no search launches the kernel; the result is the same either
    way."""
    poses, _, scans = log
    gt = torch.from_numpy(poses.astype(np.float32))
    grid = integrate_scans(empty_grid(spec_for_trajectory(poses, 8.0, 0.1)), LMS211, scans, gt)
    g = torch.Generator().manual_seed(5)
    state = pf.init_from_noise(gt[3], torch.randn(12, 2, generator=g), torch.randn(12, generator=g),
                               0.05, 0.03)
    args = (grid, LMS211, scans.ranges[3], ~scans.bad[3])
    off = pf.update_raycast_icp(state, *args, chunk=chunk)
    assert registry.report() == {} and registry.counts() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = pf.update_raycast_icp(state, *args, chunk=chunk)
    assert torch.equal(on.log_w, off.log_w) and torch.equal(on.poses, off.poses)
    rep = registry.report()
    assert {n: rep[n]["count"] for n in PF_ICP_SPANS} == dict.fromkeys(PF_ICP_SPANS, 1)
    n = LMS211.n_beams
    assert registry.counts() == dict(zip(PF_ICP_COUNTERS, (
        12 * n * n * 10, 1 if chunk is None else 3, 12 * n, 1)))
    assert not set(registry.counts()) & set(ICP_KERNEL_COUNTERS)
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e.time_range)
    (update,), (march,), (search,) = (events[name] for name in PF_ICP_SPANS)
    assert len(events["h1_nearest_two"]) == 10 * (1 if chunk is None else 3)
    for inner, outer in [(march, update), (search, update)] + [
            (r, search) for r in events["h1_nearest_two"]]:
        assert outer.start <= inner.start and inner.end <= outer.end
    assert march.end <= search.start


def test_relocalize_span_holds_the_update_and_counters_count(registry, log):
    """Off, a relocalization and the free-cell table record nothing; under
    ``enable()`` the table counts its length in ``pf.reloc_free_cells``;
    under a window ``pf.relocalize`` is one range around the sampler, the
    ray-cast + ICP update (``pf.update`` with ``pf.raycast`` and ``pf.icp``
    inside) and the top ``n_keep``, and the counters add the samples and
    the kept particles of the call; the result is the same either way."""
    poses, _, scans = log
    gt = torch.from_numpy(poses.astype(np.float32))
    grid = integrate_scans(empty_grid(spec_for_trajectory(poses, 8.0, 0.1)), LMS211, scans, gt)
    free = pf.free_cells(grid)
    assert registry.counts() == {}
    registry.enable()
    pf.free_cells(grid)
    assert registry.counts() == {"pf.reloc_free_cells": free.numel()}
    registry.disable()
    registry.reset()
    u = torch.rand(40, 4, generator=torch.Generator().manual_seed(9))
    args = (u, free, "icp", grid, None, LMS211, scans.ranges[3], ~scans.bad[3], 16)
    off = pf.global_relocalize_at(*args)
    assert registry.report() == {} and registry.counts() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = pf.global_relocalize_at(*args)
    assert torch.equal(on.log_w, off.log_w) and torch.equal(on.poses, off.poses)
    rep = registry.report()
    assert {n: rep[n]["count"] for n in ("pf.relocalize", *PF_ICP_SPANS)} == dict.fromkeys(
        ("pf.relocalize", *PF_ICP_SPANS), 1)
    counts = registry.counts()
    assert {n: counts[n] for n in PF_RELOC_COUNTERS} == {"pf.reloc_samples": 40,
                                                         "pf.reloc_kept": 16}
    assert counts["pf.icp_pairs"] == 40 * LMS211.n_beams ** 2 * 10
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e.time_range)
    (outer,) = events["pf.relocalize"]
    for name in PF_ICP_SPANS:
        (inner,) = events[name]
        assert outer.start <= inner.start and inner.end <= outer.end


def test_h2_range_appears_under_a_window(registry, log):
    _, _, scans = log
    ref = type(scans)(*(x[:2] for x in scans))
    cur = type(scans)(*(x[1:3] for x in scans))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        match_correlative(LMS211, ref, cur, search_xy=0.3, n_theta=8)
    names = [e.name for e in prof.events()]
    assert "h2_score_volume_conv" in names
    assert registry.report()["h2_score_volume_conv"]["count"] >= 1
