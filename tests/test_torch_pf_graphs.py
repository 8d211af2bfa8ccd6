"""The particle filter's phases through ``utils/cuda_graphs`` on the CPU.

On CPU tensors every phase runs its code eagerly: the results equal the
benchmark's frozen copy of the filter (``benchmark/reference/slam``) bit
for bit, and the graph counters stay at 0. The cache's own logic (warm-up,
capture, copy-in, replay, clones, the bound, ``clear``, two threads on one
stream) is held with a stand-in for the captured graph that recomputes
the function on the static buffers, as a replay does; the card's own
graphs are held in ``tests/test_torch_cuda.py``.
"""

import functools
import os
import sys
import threading

import numpy as np
import pytest
import torch

from laser_slam_tpu_torch.core.scan import LMS211
from laser_slam_tpu_torch.localization import particle_filter as pf
from laser_slam_tpu_torch.localization.raycast import likelihood_field
from laser_slam_tpu_torch.mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
from laser_slam_tpu_torch.ops.preprocess import preprocess
from laser_slam_tpu_torch.utils import cuda_graphs
from laser_slam_tpu_torch.utils.profiling import profiler

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
import synthetic_log  # noqa: E402
from benchmark.reference.slam.localization import particle_filter as frozen  # noqa: E402

torch.set_num_threads(1)

PHASES = (pf._predicted, pf._field_weights, pf._maybe_resampled, pf._estimated)


@pytest.fixture(scope="module")
def room():
    """A short lap in the test room: ground truth ``[40, 3]``, the
    preprocessed scans, the 10 cm map of the lap and its field."""
    rng = np.random.default_rng(7)
    th = np.linspace(0.0, 1.2, 40)
    gt = np.stack([0.5 + 0.6 * np.cos(th), 0.4 * np.sin(th), th + np.pi / 2], 1)
    r = synthetic_log.ray_cast(synthetic_log.room_walls(), gt,
                               LMS211.bearings(torch.float64).numpy(), LMS211.max_range)
    r = np.where(r <= LMS211.max_range, r + rng.normal(0, 0.01, r.shape), r)
    scans = preprocess(torch.from_numpy(r.astype(np.float32)), LMS211)
    gt = torch.from_numpy(gt.astype(np.float32))
    grid = integrate_scans(empty_grid(spec_for_trajectory(gt.numpy(), 8.0, 0.1)), LMS211, scans,
                           gt)
    return gt, scans, grid, likelihood_field(grid)


@pytest.fixture
def registry():
    profiler.disable()
    profiler.reset()
    profiler.enable()
    yield profiler
    profiler.disable()
    profiler.reset()


@pytest.fixture
def fresh_graphs():
    pf.GRAPHS.clear()
    yield pf.GRAPHS
    pf.GRAPHS.clear()


def draws(n, ticks, seed=5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(ticks, n, 2, generator=g), torch.randn(ticks, n, generator=g),
            torch.rand(ticks, generator=g))


def lap(module, room, n, ticks, u_kind="tensor", top_k=8):
    """``ticks`` ticks of ``module``'s phases (the program's or the frozen
    copy): every state and estimate, on the same draws."""
    gt, scans, grid, field = room
    xy, t, u = draws(n, ticks)
    g = torch.Generator().manual_seed(11)
    state = module.init_from_noise(gt[0], torch.randn(n, 2, generator=g),
                                   torch.randn(n, generator=g), 0.05, 0.03)
    out = []
    for k in range(ticks):
        i = 1 + k
        rel = torch.tensor([0.03, 0.0, 0.03])
        valid = ~scans.bad[i] & (scans.ranges[i] < LMS211.max_range)
        moved = module.predict_with_noise(state, rel, xy[k], t[k], 0.05, 0.03)
        weighted = module.update_field(moved, field, grid, LMS211, scans.ranges[i], valid)
        state = module.maybe_resample_at(weighted, u[k] if u_kind == "tensor" else float(u[k]))
        out.append((moved, weighted, state, module.estimate(state, top_k)))
    return out


@pytest.mark.parametrize("n,u_kind", [(64, "tensor"), (64, "float"), (257, "tensor")])
def test_cpu_phases_are_todays_code(room, registry, fresh_graphs, n, u_kind):
    """Bit for bit the frozen copy of the phases, on tensor and Python-float
    uniforms; no graph, no counter, no key kept."""
    got = lap(pf, room, n, 12, u_kind)
    want = lap(frozen, room, n, 12, u_kind)
    for tick_got, tick_want in zip(got, want):
        for a, b in zip(tick_got[:3], tick_want[:3]):
            assert torch.equal(a.poses, b.poses) and torch.equal(a.log_w, b.log_w)
        assert torch.equal(tick_got[3], tick_want[3])
    resampled = sum(bool(torch.all(s.log_w == s.log_w[0])) for _, _, s, _ in got)
    assert 0 < resampled < len(got)            # both branches of the select ran
    assert not set(registry.counts()) & set(pf.GRAPHS.counters)
    assert sizes(fresh_graphs) == {}


@pytest.mark.parametrize("args", [
    (torch.zeros(3),),
    (torch.zeros(3), torch.zeros(4, 3)),
    (torch.zeros(3), 0.5),
    (0.5,),
])
def test_cpu_tensors_and_numbers_do_not_replay(args):
    """Only CUDA tensors replay; a Python number (``u`` as a float) never
    does, whatever the tensors beside it."""
    assert not cuda_graphs.replayable(args)


def sizes(cache):
    """The keys the cache holds for each function, by the function's name."""
    return {fn.__name__: len(keys) for fn, keys in cache._graphs.items()}


def _scaled(x, y, scale=1.0):
    return x * scale + y


def test_key_ignores_addresses_not_shapes_or_scalars():
    """The key of a call: the function and what it binds (a tensor by its
    address, shape, strides and dtype; a number as it is), with the
    arguments' shapes, strides and dtypes; a bound tensor is held."""
    a, b = torch.zeros(8, 3), torch.ones(8, 3)
    view = torch.zeros(5, 8, 3)[2]                  # a view into the draws: another address
    assert a.data_ptr() != b.data_ptr() != view.data_ptr()
    field = torch.zeros(4, 4)

    def key(*args, fn=functools.partial(_scaled, scale=0.5)):
        return cuda_graphs.call_key(fn, args)[0]

    assert key(a) == key(b) == key(view)
    assert key(a) != key(torch.zeros(9, 3))
    assert key(a) != key(a.double())
    assert key(a) != key(torch.zeros(3, 8).T)
    assert key(a) != key(a, fn=functools.partial(_scaled, scale=0.25))
    assert key(a) != key(a, fn=functools.partial(_scaled, y=1.0, scale=0.5))
    assert key(a) != key(a, fn=_scaled)
    on_field = key(a, fn=functools.partial(_scaled, y=field))
    assert on_field == key(b, fn=functools.partial(_scaled, y=field))
    assert on_field != key(a, fn=functools.partial(_scaled, y=field.clone()))
    assert on_field != key(a, fn=functools.partial(_scaled, y=field.view(16)))
    assert cuda_graphs.call_key(functools.partial(_scaled, y=field), (a,))[1] == (field,)
    assert cuda_graphs.call_key(_scaled, (a, b))[1] == ()


def test_phase_keys_follow_shapes_scalars_and_the_field(room, monkeypatch):
    """The keys the four phases hand the cache: equal for every tick of a
    lap and for a second lap's new tensors; another cloud size, another
    ``top_k`` or predict noise, or another field tensor, another key; the
    update holds its field."""
    keys, held = [], []

    def record(fn, *args):
        key, bound = cuda_graphs.call_key(fn, args)
        keys.append(key)
        held.append(bound)
        return fn(*args)

    monkeypatch.setattr(pf, "GRAPHS", record)
    lap(pf, room, 64, 3)
    lap(pf, room, 64, 2)
    assert len(keys) == 20 and len(set(keys)) == 4
    assert [k[0] for k in keys[:4]] == list(PHASES)
    assert [len(h) for h in held[:4]] == [0, 1, 0, 0] and held[1][0] is room[3]
    first = set(keys)
    keys.clear()
    lap(pf, room, 65, 1)
    lap(pf, room, 64, 1, top_k=4)
    assert len(set(keys) - first) == 5             # 65: all four phases; top_k: the estimate
    gt, scans, grid, field = room
    state = pf.init_from_noise(gt[0], torch.zeros(64, 2), torch.zeros(64))
    keys.clear()
    valid = ~scans.bad[1]
    pf.update_field(state, field, grid, LMS211, scans.ranges[1], valid)
    pf.update_field(state, field.clone(), grid, LMS211, scans.ranges[1], valid)
    pf.predict_with_noise(state, torch.zeros(3), torch.zeros(64, 2), torch.zeros(64), 0.1, 0.03)
    assert keys[0] != keys[1] and keys[2] not in first


class _Replayed:
    """A stand-in for a captured graph: a replay computes the function on
    the static inputs into the static outputs, in place."""

    def __init__(self, fn, inputs, outputs, held):
        self.fn, self.inputs, self.outputs, self.held = fn, inputs, outputs, held

    def replay(self):
        got = self.fn(*self.inputs)
        pairs = [(self.outputs, got)] if torch.is_tensor(got) else zip(self.outputs, got)
        for dst, src in pairs:
            dst.copy_(src)


@pytest.fixture
def stand_in(monkeypatch):
    """Every call counts as replayable on one stream; a capture makes a
    :class:`_Replayed`. Returns what each capture was asked to hold."""
    held_by_capture = []

    def capture(fn, args, held, stream):
        inputs = tuple(torch.empty_like(a).copy_(a) for a in args)
        held_by_capture.append(held)
        return _Replayed(fn, inputs, fn(*inputs), held)

    monkeypatch.setattr(cuda_graphs, "replayable", lambda args: True)
    monkeypatch.setattr(cuda_graphs, "_current_stream", lambda: (0, 0))
    monkeypatch.setattr(cuda_graphs, "_capture", capture)
    return held_by_capture


def test_warm_up_capture_then_replay_and_clones(registry, stand_in):
    """First call eager, second captures and replays, later calls replay;
    each returns a clone that later calls leave unchanged."""
    cache = cuda_graphs.GraphCache("t")
    double = lambda x: (2.0 * x, x + 1.0)         # noqa: E731
    outs = [cache(double, torch.full((4,), float(i))) for i in range(5)]
    for i, (two, plus) in enumerate(outs):
        assert torch.equal(two, torch.full((4,), 2.0 * i))
        assert torch.equal(plus, torch.full((4,), i + 1.0))
    assert len({o[0].data_ptr() for o in outs}) == 5
    assert registry.counts() == {"t.graph_captures": 1, "t.graph_replays": 4}
    assert len(stand_in) == 1


def test_pf_phases_through_the_stand_in_are_eager_bit_for_bit(room, registry, fresh_graphs,
                                                              stand_in):
    """The four phases over a lap: every state and estimate equal the
    eager lap's; captures 4, replays 4 x (ticks - 1); the update holds its
    field."""
    ticks = 8
    got = lap(pf, room, 64, ticks)
    want = lap(frozen, room, 64, ticks)
    for tick_got, tick_want in zip(got, want):
        for a, b in zip(tick_got[:3], tick_want[:3]):
            assert torch.equal(a.poses, b.poses) and torch.equal(a.log_w, b.log_w)
        assert torch.equal(tick_got[3], tick_want[3])
    assert registry.counts() == {"pf.graph_captures": 4, "pf.graph_replays": 4 * (ticks - 1)}
    assert sizes(fresh_graphs) == {fn.__name__: 1 for fn in PHASES}
    assert [len(h) for h in stand_in] == [0, 1, 0, 0] and stand_in[1][0] is room[3]


def test_cache_keeps_its_bound_and_clears(registry, stand_in):
    """At most ``PER_FUNCTION`` keys a function, the least recently used
    dropped first; ``clear`` empties the cache."""
    assert cuda_graphs.PER_FUNCTION == 4
    cache = cuda_graphs.GraphCache("t")
    for n in range(1, 9):
        cache(torch.neg, torch.zeros(n))
        cache(torch.neg, torch.zeros(n))
        cache(torch.abs, torch.zeros(1))
        assert max(sizes(cache).values()) <= 4
    assert sizes(cache) == {"neg": 4, "abs": 1}
    cache(torch.neg, torch.zeros(5))               # kept: replays
    cache(torch.neg, torch.zeros(1))               # dropped long ago: a warm-up again
    assert registry.counts() == {"t.graph_captures": 9, "t.graph_replays": 9 + 7}
    cache.clear()
    assert sizes(cache) == {}
    cache(torch.neg, torch.zeros(5))               # after clear: a warm-up, nothing counted
    assert registry.counts()["t.graph_replays"] == 16


@pytest.fixture
def switch_often():
    """The interpreter switches threads every microsecond, so that a
    section left unguarded interleaves."""
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(before)


def test_two_threads_on_one_stream_get_their_own_results(registry, stand_in, switch_often):
    """Threads calling the same function on one stream at once (as the
    online session's robot loop and its pose server do): each call returns
    its own inputs' result, never another thread's, through warm-up,
    capture and replays."""
    cache = cuda_graphs.GraphCache("t")
    scaled = functools.partial(_scaled, scale=3.0)
    wrong, start = [], threading.Barrier(4)

    def worker(offset):
        start.wait()
        for i in range(500):
            x = torch.full((64,), float(offset + i))
            y = torch.full((64,), float(-i))
            got = cache(scaled, x, y)
            if not torch.equal(got, _scaled(x, y, 3.0)):
                wrong.append((offset, i))

    threads = [threading.Thread(target=worker, args=(k * 10_000,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrong == []
    assert registry.counts() == {"t.graph_captures": 1, "t.graph_replays": 1999}
