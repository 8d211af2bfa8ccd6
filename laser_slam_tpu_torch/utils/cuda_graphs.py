"""Fixed-shape device work as captured CUDA graphs: the same kernels, one
launch from the host.

A function of tensors that issues many small kernels costs the host
~10-20 µs a launch while the device runs each in a few. A
:class:`GraphCache` captures such a function once as a
``torch.cuda.CUDAGraph`` and replays it on every later call with the same
key:

- the first call with a new key runs the function eagerly: lazy
  initialisation and the allocator's growth happen there;
- the second copies the tensor arguments into static buffers that the
  cache owns, captures the function into a graph and replays it;
- every later call copies the arguments in and replays the graph.

Every call that replays returns clones of the graph's outputs, never its
own buffers, so a tensor handed back never changes afterwards. The
replay runs the very kernels the eager call runs, with the same launch
shapes, so its results are the eager ones bit for bit.

Which calls replay: only those whose every argument is a CUDA tensor on
the current device that does not require grad, while no capture is under
way on the current stream (:func:`replayable`). Every other call (CPU
tensors, grad, a Python number among the arguments, a caller that is
itself capturing) runs the function eagerly and touches no cache.

The key (:func:`call_key`) is read off the call itself. The function is
a plain function or a ``functools.partial``; what the partial binds is
part of the key: a Python value as it is, a tensor by its address,
shape, strides and dtype, for the graph reads it where it lies (the
cache keeps such a tensor alive, so that the address stays valid). To
that come the shapes, strides and dtypes of the call's tensor arguments
and the current stream; never the arguments' addresses, so new tensors
of the same shapes replay.

A graph freezes the code path it captured. A test that monkeypatches a
callee of a captured function must call :meth:`GraphCache.clear`
afterwards, or the old kernels keep running.

A replay is launched inside the package's dispatcher operator
``laser_slam_tpu_torch::graph_replay`` (registered where the package's
one operator namespace is defined, ``ops/cuda/nvcc``): under
``torch.profiler`` the graph's kernels are then linked to that operator,
and through it to the program's span around the call, as PyTorch's own
kernels are. A replay from outside any operator is linked to none.

Threads: one lock of the process is held from the copy-in through the
clones out, the capture included. Two host threads on one stream (the
online session's robot loop and its pose server) then never overwrite
each other's static inputs, and a replay's outputs are cloned before
any other replay is enqueued. Only one capture runs at a time, as CUDA
graphs ask, so captures use PyTorch's default capture stream.

Memory: the graphs of one stream capture into one pool, since work on
one stream runs in the order the lock enqueued it; graphs replayed on
another stream get a pool of their own, for their device work may
overlap. At most :data:`PER_FUNCTION` keys are kept for each function,
the least recently used dropped first, so a caller looping over many
shapes or fields stays bounded.

Counters (``utils/profiling``, host integers, no fetch):
``<prefix>.graph_captures`` adds one a capture, ``<prefix>.graph_replays``
one a replay; the capturing call replays too and counts there.
"""

from __future__ import annotations

import collections
import functools
import threading
import weakref
from typing import Callable

import torch

from ..ops.cuda import nvcc
from .profiling import profiler

Tensor = torch.Tensor

PER_FUNCTION = 4                  # keys (graphs) kept for each function

_lock = threading.Lock()          # copy-in, capture, replay and clones of every cache
_pools: dict = {}                 # (device, stream) -> graph pool handle
_live = weakref.WeakValueDictionary()    # id -> captured graph, for the replay operator


def _replay_graph(anchor: Tensor, graph: int) -> None:
    _live[graph].replay()


nvcc.register("graph_replay(Tensor anchor, int graph) -> ()", _replay_graph)
_graph_replay = torch.ops.laser_slam_tpu_torch.graph_replay


class _Graph:
    """A captured graph with its static inputs and outputs, and the
    tensors it reads where they lie (``held``)."""

    __slots__ = ("graph", "inputs", "outputs", "held")

    def __init__(self, graph, inputs, outputs, held):
        self.graph, self.inputs, self.outputs, self.held = graph, inputs, outputs, held
        _live[id(graph)] = graph

    def replay(self) -> None:
        """Launches the graph on the current stream, inside its operator
        (on the static inputs' device)."""
        _graph_replay(self.inputs[0], id(self.graph))


def replayable(args: tuple) -> bool:
    """Whether a call with ``args`` may replay a graph: every argument a
    CUDA tensor on the current device that does not require grad, and
    no capture under way on the current stream."""
    for a in args:
        if not isinstance(a, Tensor) or not a.is_cuda or a.requires_grad:
            return False
    dev = torch.cuda.current_device()
    if any(a.get_device() != dev for a in args):
        return False
    return not torch.cuda.is_current_stream_capturing()


def _bound(value):
    if isinstance(value, Tensor):
        return value.data_ptr(), value.shape, value.stride(), value.dtype
    return value


def call_key(fn: Callable, args: tuple) -> tuple[tuple, tuple]:
    """The key of calling ``fn`` on the tensor ``args`` (module
    docstring), and the tensors ``fn`` binds, which a graph of it reads
    where they lie."""
    func, bound, named = fn, (), {}
    if isinstance(fn, functools.partial):
        func, bound, named = fn.func, fn.args, fn.keywords
    held = tuple(v for v in (*bound, *named.values()) if isinstance(v, Tensor))
    key = (func, tuple(_bound(v) for v in bound),
           tuple(sorted((k, _bound(v)) for k, v in named.items())),
           *((a.shape, a.stride(), a.dtype) for a in args))
    return key, held


def _current_stream() -> tuple[int, int]:
    """The current device and the raw handle of its current stream (a
    host read of ~0.3 µs; ``torch.cuda.current_stream()`` builds a
    ``Stream`` object in ~6 µs)."""
    dev = torch.cuda.current_device()
    return dev, torch._C._cuda_getCurrentRawStream(dev)


def _capture(fn: Callable, args: tuple, held: tuple, stream: tuple[int, int]) -> _Graph:
    """Captures ``fn`` on static copies of ``args`` (under the lock)."""
    pool = _pools.get(stream)
    if pool is None:
        pool = _pools[stream] = torch.cuda.graph_pool_handle()
    inputs = tuple(torch.empty_like(a) for a in args)
    torch._foreach_copy_(inputs, args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        out = fn(*inputs)
    return _Graph(graph, inputs, out, held)


def _clone(out):
    if isinstance(out, Tensor):
        return out.clone()
    return tuple(o.clone() for o in out)


class GraphCache:
    """Captured graphs of functions of tensors, by key (module docstring);
    ``prefix`` names the counters."""

    def __init__(self, prefix: str):
        self.counters = (f"{prefix}.graph_captures", f"{prefix}.graph_replays")
        self._graphs: dict[Callable, collections.OrderedDict] = {}   # function -> key -> graph

    def __call__(self, fn: Callable, *args):
        """``fn(*args)``: eagerly, or as a replay of its graph; a tensor or
        a tuple of tensors."""
        if not replayable(args):
            return fn(*args)
        stream = _current_stream()
        key, held = call_key(fn, args)
        key += (stream,)
        with _lock:
            keys = self._graphs.setdefault(key[0], collections.OrderedDict())
            if key in keys:
                keys.move_to_end(key)
                entry = keys[key]
                if entry is None:
                    entry = keys[key] = _capture(fn, args, held, stream)
                    profiler.count(self.counters[0])
                else:
                    torch._foreach_copy_(entry.inputs, args)   # one launch where the dtypes agree
                entry.replay()
                profiler.count(self.counters[1])
                return _clone(entry.outputs)
            keys[key] = None                       # the warm-up: seen once, no graph yet
            while len(keys) > PER_FUNCTION:
                keys.popitem(last=False)
        return fn(*args)

    def clear(self) -> None:
        """Drops every key and graph."""
        with _lock:
            self._graphs.clear()
