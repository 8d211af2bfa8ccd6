"""The point-ICP nearest-two search on the CPU: the plain block
(``icp_points._nearest_two_plain``, what CPU tensors run and what the
kernel ``csrc/icp_nearest_kernel.cu`` is held to bit for bit on the card,
``tests/test_torch_cuda.py -k nearest_two``) at ties, masked rows, a row
with one valid point and points that are not finite; CPU tensors taking
it with no launch and no counter; ``match_icp_points`` bit for bit the
benchmark's frozen copy; the kernel's wrapper refusing what it does not
take.
"""

import os
import sys

import numpy as np
import pytest
import torch

from laser_slam_tpu_torch.ops import icp_points
from laser_slam_tpu_torch.ops.cuda import icp_nearest_kernel
from laser_slam_tpu_torch.utils.profiling import profiler

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
from benchmark.reference.slam.ops import icp_points as frozen  # noqa: E402
from icp_search_cases import edge_cases, scan_clouds  # noqa: E402

torch.set_num_threads(1)

F = np.float32


def test_plain_block_answers_at_edge_cases():
    """``torch.argmin``'s rules, which the kernel keeps: the first of
    equal distances, then the next; a row with no candidate gives index 0
    and no match; a row with one gives it and index 0 as the second; a
    point that is not finite matches nothing."""
    q, ref, ok = (torch.from_numpy(x) for x in edge_cases())
    j, j2, nn_ok = (w.numpy() for w in icp_points._nearest_two_plain(q, ref, ok))
    assert j[0, 3] == 2 and j2[0, 3] == 5 and nn_ok[0, 3]
    assert not nn_ok[2].any() and (j[2] == 0).all() and (j2[2] == 0).all()
    assert (j[3] == 6).all() and (j2[3] == 0).all() and nn_ok[3].all()
    assert not nn_ok[4, 1:4].any()


def test_cpu_tensors_take_the_plain_block_and_launch_nothing():
    q, ref, ok = edge_cases()
    args = (torch.from_numpy(q), torch.from_numpy(ref), torch.from_numpy(ok))
    before = icp_nearest_kernel.nearest_two.launches
    profiler.reset()
    profiler.enable()
    try:
        got = icp_points._nearest_two(*args)
        for dtype in (torch.float64, torch.bfloat16):
            icp_points._nearest_two(args[0].to(dtype), args[1].to(dtype), args[2])
        counts = profiler.counts()
    finally:
        profiler.disable()
        profiler.reset()
    assert icp_nearest_kernel.nearest_two.launches == before
    assert "icp.nearest_two_launches" not in counts
    assert all(torch.equal(g, w) for g, w in zip(got, icp_points._nearest_two_plain(*args)))
    assert not icp_points.searches_on_kernel(args[0], args[1])


@pytest.mark.parametrize("iters,steps_per_nn", [(10, 1), (15, 1), (12, 2)])
def test_match_icp_points_is_the_frozen_copy_on_the_cpu(iters, steps_per_nn):
    """The whole match, search and update, bit for bit the benchmark's
    frozen ``match_icp_points`` (the search still written inline there),
    with an expanded reference cloud as ``update_icp`` passes it."""
    q, ref, ok = scan_clouds(6, 91, 120, seed=iters)
    cur, cur_ok = torch.from_numpy(q), torch.ones(6, 91, dtype=torch.bool)
    cur_ok[:, ::7] = False
    init = torch.from_numpy(np.random.default_rng(1).normal(0, 0.05, (6, 3)).astype(F))
    for r, v in ((torch.from_numpy(ref), torch.from_numpy(ok)),
                 (torch.from_numpy(ref[:1]).expand(6, 120, 2), torch.from_numpy(ok[:1]).expand(6, 120))):
        got = icp_points.match_icp_points(r, v, cur, cur_ok, init, iters=iters, max_corr=0.6,
                                          steps_per_nn=steps_per_nn)
        want = frozen.match_icp_points(r, v, cur, cur_ok, init, iters=iters, max_corr=0.6,
                                       steps_per_nn=steps_per_nn)
        for name, g, w in zip(got._fields, got, want):
            assert torch.equal(g, w), name


def test_nearest_two_rejects_what_it_does_not_take():
    q = torch.zeros(2, 5, 2)
    ref = torch.zeros(2, 7, 2)
    ok = torch.ones(2, 7, dtype=torch.bool)
    meta = [t.to("meta") for t in (q, ref, ok)]
    before = icp_nearest_kernel.nearest_two.launches
    for bad, why in (((q, ref, ok), "one CUDA device"),
                     ((*meta,), "one CUDA device"),
                     ((q[0], ref, ok), r"\[B, N, 2\]"),
                     ((q, ref[..., :1], ok), r"\[B, N, 2\]"),
                     ((q, ref, ok[:, :3]), r"\[B, M\]"),
                     ((q[:1], ref, ok), r"\[B, M\]"),
                     ((q.double(), ref.double(), ok), "float32"),
                     ((q, ref, ok.float()), "bool"),
                     ((q, ref[:, :0], ok[:, :0]), "out of range"),
                     ((torch.zeros(2, 2, 5).transpose(1, 2), ref, ok), "contiguous")):
        with pytest.raises(ValueError, match=why):
            icp_nearest_kernel.nearest_two(*bad)
    assert icp_nearest_kernel.nearest_two.launches == before
