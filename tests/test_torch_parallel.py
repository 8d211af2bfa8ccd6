"""Port parity: ``parallel/`` of ``laser_slam_tpu_torch`` (meshes over
``torch.distributed``, the sharded matchers, the edge-sharded solve)
against ``laser_slam_tpu``'s on a 2-device CPU mesh, in this process with
a one-rank gloo group on a ``HashStore`` (no port is bound). Two ranks in
two processes are ``tests/test_torch_multiprocess.py``.

Bounds: the matchers' own parity bounds (``tests/test_torch_psm.py``,
``tests/test_torch_icp.py``) on the same inputs; the solve at
``tests/test_torch_graph.py``'s ``CHI2_RTOL`` and ``POSE_ATOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from conftest import box_room_ranges
from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.core import se2 as jse2
from laser_slam_tpu.graph import solve as jsolve
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu.parallel import distributed as jdist
from laser_slam_tpu.parallel import mesh as jmesh
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.core.scan import Scan
from laser_slam_tpu_torch.graph import solve as tsolve
from laser_slam_tpu_torch.ops import icp as ticp
from laser_slam_tpu_torch.ops import plicp as tplicp
from laser_slam_tpu_torch.ops import psm as tpsm
from laser_slam_tpu_torch.ops.cuda import psm_kernel
from laser_slam_tpu_torch.parallel import distributed as tdist
from laser_slam_tpu_torch.parallel import mesh as tmesh
from laser_slam_tpu_torch.parallel import multihost
from test_torch_graph import CHI2_RTOL, POSE_ATOL, loop_graph
from test_torch_psm import both as psm_pairs

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
BOUNDS = {   # (pose atol, err rtol, err atol) from the matchers' parity tests
    "psm": (1e-4, 1e-4, 0.0),
    "icp": (1e-5, 0.0, 1e-5),
    "plicp": (1e-5, 0.0, 1e-5),
}


@pytest.fixture(scope="module")
def mesh():
    assert not dist.is_initialized()
    m = tmesh.make_mesh(device="cpu")
    yield m
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(2)


def test_mesh_helpers(mesh):
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh.device_type == "cpu" and mesh.mesh_dim_names == (tmesh.DATA_AXIS,)
    assert tmesh.DATA_AXIS == jmesh.DATA_AXIS
    assert tmesh.rank_and_size(mesh) == (0, 1)
    assert tmesh.batch_sharding(mesh).placements[0].is_shard(0)
    assert tmesh.replicated(mesh).placements[0].is_replicate()
    with pytest.raises(ValueError, match="process group has 1"):
        tmesh.make_mesh(2)
    scan = Scan(torch.zeros(4, 181), torch.zeros(4, 181, dtype=torch.bool),
                torch.zeros(4, 181, dtype=torch.int32))
    mine = tmesh.shard_batch(mesh, {"scan": scan, "none": None})
    assert mine["none"] is None and all(torch.equal(a, b) for a, b in zip(mine["scan"], scan))
    # Over 2 ranks, rank 1 holds rows 2-3.
    assert tmesh.rows_of_rank(4, 1, 2) == slice(2, 4)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tmesh.rows_of_rank(5, 0, 2)
    multihost.initialize("127.0.0.1:1", 1, 0, device="cpu")   # a group exists: no-op
    assert multihost.is_primary()
    assert multihost.global_mesh().size() == 1


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (3, 1), (1, 8)])
def test_pad_to_multiple_matches_jax(n, multiple):
    rng = np.random.default_rng(n)
    tree = (rng.normal(size=(n, 3)).astype(np.float32),
            {"b": rng.integers(0, 9, (n,)), "c": rng.normal(size=(n, 2, 2))})
    got, got_n = tmesh.pad_to_multiple(tree, multiple)
    want, want_n = jmesh.pad_to_multiple(tree, multiple)
    assert got_n == want_n == n
    for a, b in zip(tmesh.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
        assert a.shape[0] % multiple == 0


def _box_pairs():
    """8 box-room pairs (a random pose, a motion of up to 30 cm and 0.25
    rad, 4 mm noise), preprocessed by JAX, as in ``test_torch_icp.py``."""
    rng = np.random.default_rng(0)
    a, b = [], []
    for _ in range(8):
        pa = np.array([rng.uniform(-1.5, 2.5), rng.uniform(-2, 2), rng.uniform(-np.pi, np.pi)])
        rel = np.array([rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), rng.uniform(-0.25, 0.25)])
        a.append(box_room_ranges(MODEL, pa) + rng.normal(0, 0.004, MODEL.n_beams))
        b.append(box_room_ranges(MODEL, jse2.np_compose(pa, rel)) + rng.normal(0, 0.004, MODEL.n_beams))
    ja = jpp.preprocess(jnp.asarray(np.float32(a)), MODEL)
    jb = jpp.preprocess(jnp.asarray(np.float32(b)), MODEL)
    return MODEL, TMODEL, ja, jb, *(interop.scan_from_numpy(*(np.asarray(x) for x in s))
                                    for s in (ja, jb))


# Rows matched apart (two ranks) against the whole batch (one rank): the
# pairs' own computation is the same, but torch's CPU ``atan2`` (in the
# projection) has a vectorized body and a scalar tail that round apart in
# the last bit, and which elements fall in the tail depends on the batch
# size (6 of 1448 elements of an LMS211 batch of 8 against two of 4). The
# CUDA kernel has no such tail. So on the CPU the halves are held to one
# float32 step of the pose here, and bit for bit where the batch shape
# stays the same (``test_a_frozen_pair_is_untouched_by_its_neighbours``).
HALVES_ATOL = 1e-6


def _plain(matcher):
    return {"psm": psm_kernel.match_psm_fused, "icp": ticp.match_icp,
            "plicp": tplicp.match_plicp}[matcher]


def _pairs(matcher):
    if matcher == "psm":
        jm, tm, ja, jb, ta, tb, _ = psm_pairs("LMS211")
        return jm, tm, ja, jb, ta, tb
    return _box_pairs()


def _rows(scan, idx):
    return Scan(*(x[idx] for x in scan))


@pytest.mark.parametrize("matcher", ["psm", "icp", "plicp"])
def test_sharded_batch_match_matches_jax(mesh, jax_mesh, matcher):
    """The sharded matchers against JAX's on a 2-device mesh and against
    the undistributed call bit for bit; each half of the batch matched
    alone (what two ranks match) against the whole."""
    jm, tm, ja, jb, ta, tb = _pairs(matcher)
    init = np.float32(np.random.default_rng(1).normal(0, [0.02, 0.02, 0.01], (8, 3)))
    want = jdist.sharded_batch_match(jax_mesh, jm, ja, jb, jnp.asarray(init), matcher=matcher)
    got = tdist.sharded_batch_match(mesh, tm, ta, tb, torch.from_numpy(init), matcher=matcher)
    assert got._fields == want._fields
    pose_atol, err_rtol, err_atol = BOUNDS[matcher]
    np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))
    ok = ~got.fail.numpy()
    assert ok.sum() >= 6
    np.testing.assert_allclose(got.pose.numpy()[ok], np.asarray(want.pose)[ok], atol=pose_atol)
    np.testing.assert_allclose(got.err.numpy()[ok], np.asarray(want.err)[ok], rtol=err_rtol,
                               atol=err_atol)

    whole = _plain(matcher)(tm, ta, tb, torch.from_numpy(init))
    halves = [_plain(matcher)(tm, _rows(ta, h), _rows(tb, h), torch.from_numpy(init)[h])
              for h in (slice(0, 4), slice(4, 8))]
    for name, g, w, h0, h1 in zip(got._fields, got, whole, *halves):
        assert torch.equal(g, w), name
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(torch.cat([h0, h1]).numpy(), w.numpy(), atol=HALVES_ATOL,
                                       rtol=0, err_msg=name)
        else:
            assert torch.equal(torch.cat([h0, h1]), w), name


@pytest.mark.parametrize("matcher", ["psm", "icp", "plicp"])
def test_a_frozen_pair_is_untouched_by_its_neighbours(matcher, monkeypatch):
    """A pair's result does not depend on how long its neighbours keep the
    loop going: with the other half of the batch replaced by pairs that
    fail at once (a blank scan), the loop ends sooner and the kept rows
    come out bit for bit as in the whole batch (same batch shape, so the
    same vectorized elements)."""
    _, tm, _, _, ta, tb = _pairs(matcher)
    blank = tb.ranges.new_full(tb.ranges.shape, TMODEL.max_range + 1.0)
    from laser_slam_tpu_torch.ops import preprocess as tpp

    tblank = tpp.preprocess(blank, tm)
    trips = []
    if matcher == "psm":
        real = tpsm.scan_project

        def counting(*a):
            trips[-1] += 1
            return real(*a)

        monkeypatch.setattr(tpsm, "scan_project", counting)

    def run(cur):
        trips.append(0)
        info = {}
        kw = {} if matcher == "psm" else {"info": info}
        return _plain(matcher)(tm, ta, cur, **kw), info

    whole, winfo = run(tb)
    shorter = 0
    for keep in (slice(0, 4), slice(4, 8)):
        mixed = Scan(*(torch.cat([b[:4], k[4:]]) if keep.start == 0 else torch.cat([k[:4], b[4:]])
                       for b, k in zip(tb, tblank)))
        res, info = run(mixed)
        assert not res.fail[slice(4, 8) if keep.start == 0 else slice(0, 4)].logical_not().any()
        for name, a, b in zip(res._fields, res, whole):
            assert torch.equal(a[keep], b[keep]), name
        if matcher == "psm":
            shorter += trips[-1] < trips[0]
        else:
            shorter += int(info["iters"].max()) < int(winfo["iters"].max())
    assert shorter >= 1


def test_fused_wrapper_refuses_the_banded_projection():
    _, tm, _, _, ta, tb, _ = psm_pairs("LMS211")
    with pytest.raises(ValueError, match="banded"):
        psm_kernel.match_psm_fused(tm, ta, tb, banded=True)
    assert not tpsm.match_psm(tm, ta, tb, banded=True).fail.any()


def _graph_pair(v, n_loops, pad, seed, kernel=True):
    fields, _ = loop_graph(seed=seed, v=v, n_loops=n_loops, n_bad=2, pad=pad)
    if not kernel:
        del fields["kernel"]
    jg = jsolve.PoseGraph(**{k: jnp.asarray(x) for k, x in fields.items()})
    return jg, interop.state_from_numpy(tsolve.PoseGraph, fields)


@pytest.mark.parametrize("v,n_loops,route", [(40, 12, "chol"), (1040, 60, "cg")])
def test_distributed_optimize_matches_jax(mesh, jax_mesh, v, n_loops, route):
    """The edge-sharded LM against JAX's ``distributed_optimize`` on a
    2-device mesh, on the dense route and (past ``DENSE_SOLVER_MAX_V``
    vertices) the CG route, and against ``optimize``: at one rank bit for
    bit.

    JAX's version places the graph's fields again and leaves out
    ``kernel``, so it weighs loop edges with Huber instead of DCS; the
    port keeps the graph's kernels (it must equal ``optimize``). The
    packages are compared on a graph without kernels, where they agree."""
    assert (v > tsolve.DENSE_SOLVER_MAX_V) == (route == "cg")
    pad = 3 if (v - 1 + n_loops) % 2 else 2
    jg, tg = _graph_pair(v, n_loops, pad, seed=3, kernel=False)
    want, jchi = jdist.distributed_optimize(jax_mesh, jg, 20)
    info = {}
    got, chi = tdist.distributed_optimize(mesh, tg, 20, info=info)
    assert info["steps"] > 0
    np.testing.assert_allclose(float(chi), float(jchi), rtol=CHI2_RTOL)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=POSE_ATOL)
    assert got.meas is tg.meas and got.i is tg.i
    for g in (tg, _graph_pair(v, n_loops, pad, seed=3)[1]):
        got, chi = tdist.distributed_optimize(mesh, g, 20)
        plain, plain_chi = tsolve.optimize(g, 20)
        assert torch.equal(got.poses, plain.poses) and torch.equal(chi, plain_chi)


def test_inactive_edge_padding_changes_nothing(mesh):
    """Edges padded to a multiple of the ranks are inactive: the solve is
    the unpadded one (only the χ² sum's order can move its last bits),
    where repeating the last edge, as ``pad_to_multiple`` does for a
    batch, would count it twice."""
    _, tg = _graph_pair(40, 12, pad=0, seed=5)
    e = tg.i.shape[0]
    padded = tdist._pad_inactive(tg, 3)
    assert padded.i.shape[0] == e + 3 and not padded.e_active[e:].any()
    got, chi = tsolve.optimize(padded, 20)
    want, want_chi = tsolve.optimize(tg, 20)
    np.testing.assert_allclose(float(chi), float(want_chi), rtol=1e-6)
    np.testing.assert_allclose(got.poses.numpy(), want.poses.numpy(), atol=1e-6)
    for rank in range(3):
        part = tdist._edges_of_rank(tg, rank, 3)
        assert part.i.shape[0] == (e + (-e) % 3) // 3
    fields = {k: getattr(tg, k).numpy() for k in ("i", "j", "meas", "info", "e_active", "kernel")}
    doubled, _ = tmesh.pad_to_multiple(fields, e + 1)
    twice = tg._replace(**{k: torch.from_numpy(x) for k, x in doubled.items()})
    assert float(tsolve.weighted_chi2(twice)) > float(tsolve.weighted_chi2(tg)) * (1 + 1e-6)
