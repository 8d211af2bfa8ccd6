"""Two processes of the PyTorch port joined in one gloo process group
(``tools/torch_multiproc_worker.py``, ``parallel.multihost.initialize``),
each running the distributed SLAM backend step ``training_step`` over 4
pairs: sharded PSM matching feeding the edge-sharded pose-graph solve.

Both ranks must print the same χ². It is held to the port's own step in
one process at 1e-6 relative (the two ranks sum the normal equations in
another order, and torch's CPU ``atan2`` rounds a batch of 2 apart from a
batch of 4 in the last bit: ``tests/test_torch_parallel.py``), and to the
JAX package's ``training_step`` on a 2-device CPU mesh at the graph
solver's parity bound, ``CHI2_RTOL`` (``tests/test_torch_graph.py``). The
worker imports no jax; this test does, for the reference.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "torch_multiproc_worker.py")
sys.path.insert(0, os.path.join(REPO, "tools"))
import torch_multiproc_worker as worker  # noqa: E402

from test_torch_graph import CHI2_RTOL  # noqa: E402

ONE_PROCESS_RTOL = 1e-6
ATTEMPTS = 3


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair():
    """Both workers' outputs; a new port when the chosen one was taken
    between choosing and binding."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    for _ in range(ATTEMPTS):
        coordinator = f"127.0.0.1:{_free_port()}"
        procs = [
            subprocess.Popen([sys.executable, WORKER, coordinator, "2", str(pid)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env, cwd=REPO)
            for pid in range(2)
        ]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=240)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if not any("EADDRINUSE" in o or "Address already in use" in o for o in outs):
            return procs, outs
    raise AssertionError(f"no free port in {ATTEMPTS} attempts:\n{outs}")


def _chi2(out: str) -> str:
    line = [ln for ln in out.splitlines() if "MULTIPROC_OK" in ln][0]
    return line.split("chi2=")[1].split()[0]


@pytest.fixture(scope="module")
def one_rank_mesh():
    from laser_slam_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_two_process_distributed_backend_step(one_rank_mesh):
    procs, outs = _run_pair()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIPROC_OK pid={pid}/2 devices=2 pairs=4" in out, out
        assert "fails=0" in out, out
    # Both ranks agree on the replicated solve.
    chi = _chi2(outs[0])
    assert chi == _chi2(outs[1])

    # The same step in one process.
    from laser_slam_tpu_torch.core.scan import LMS211
    from laser_slam_tpu_torch.parallel.distributed import training_step

    ref, cur, _ = worker.synthetic_pairs(LMS211, 4, seed=0)
    poses, one_chi, fail = training_step(one_rank_mesh, LMS211, ref, cur, worker.dryrun_graph(4))
    assert not fail.any() and poses.shape == (8, 3)
    np.testing.assert_allclose(float(chi), float(one_chi), rtol=ONE_PROCESS_RTOL)

    # JAX's step on a 2-device CPU mesh, from the dry run's own pairs.
    from __graft_entry__ import _synthetic_pairs
    from laser_slam_tpu.core import se2 as jse2
    from laser_slam_tpu.core.scan import LMS211 as JLMS211
    from laser_slam_tpu.graph.solve import PoseGraph
    from laser_slam_tpu.parallel.distributed import training_step as jstep
    from laser_slam_tpu.parallel.mesh import make_mesh, shard_batch

    mesh = make_mesh(2)
    jref, jcur, _ = _synthetic_pairs(JLMS211, 4, seed=0)
    v, e = 8, 8
    rng = np.random.default_rng(0)
    jposes = np.cumsum(rng.normal(0, 0.1, (v, 3)).astype(np.float32), axis=0)
    ei = np.arange(e, dtype=np.int32) % (v - 1)
    graph = PoseGraph(
        poses=jnp.asarray(jposes), v_active=jnp.ones(v, bool), i=jnp.asarray(ei),
        j=jnp.asarray(ei + 1),
        meas=jse2.relative(jnp.asarray(jposes[ei]), jnp.asarray(jposes[ei + 1])),
        info=jnp.asarray(np.tile(np.eye(3, dtype=np.float32) * 50.0, (e, 1, 1))),
        e_active=jnp.ones(e, bool),
    )
    want_poses, want_chi, want_fail = jstep(mesh, JLMS211, shard_batch(mesh, jref),
                                            shard_batch(mesh, jcur), graph)
    assert not np.asarray(want_fail).any()
    np.testing.assert_allclose(float(chi), float(want_chi), rtol=CHI2_RTOL)
    np.testing.assert_allclose(poses.numpy(), np.asarray(want_poses), atol=1e-3)


def test_worker_pairs_are_the_dry_runs(monkeypatch):
    """The worker's raw ranges are the JAX dry run's bit for bit (the same
    numpy sequence), and so are the preprocessed scans."""
    import __graft_entry__
    from laser_slam_tpu.core.scan import LMS211 as JLMS211
    from laser_slam_tpu.ops import preprocess as jpp
    from laser_slam_tpu_torch.core.scan import LMS211

    raw = []
    real = jpp.preprocess

    def capture(ranges, model):
        raw.append(np.asarray(ranges))
        return real(ranges, model)

    monkeypatch.setattr(jpp, "preprocess", capture)
    jref, jcur, jrel = __graft_entry__._synthetic_pairs(JLMS211, 6, seed=0)
    ref, cur, rel = worker.synthetic_pair_ranges(LMS211, 6, seed=0)
    np.testing.assert_array_equal(ref, raw[0])
    np.testing.assert_array_equal(cur, raw[1])
    np.testing.assert_array_equal(rel, jrel)
    tref, tcur, _ = worker.synthetic_pairs(LMS211, 6, seed=0)
    for a, b in zip((*tref, *tcur), (*jref, *jcur)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
