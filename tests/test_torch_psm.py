"""Port parity: the plain PSM matcher and ``error_index`` of
``laser_slam_tpu_torch`` against ``laser_slam_tpu``; the fused PSM
wrapper on CPU tensors (the fused CUDA kernel against the plain version
on the card is tests/test_torch_cuda.py).

XLA's and PyTorch's float32 ``atan2``/``cos`` differ in the last bit on a
few percent of inputs. In the first projection of a match from the zero
pose, a bin at a segment end lies within a last bit of its covering
pair's bearing, so such a difference can move one bin between empty and
covered; the match then settles up to a few mm apart (seen on about one
pair in ten across seeds). The fixed seed's pairs do not hit that case,
so the 1e-4 bound below holds the port to float round-off.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on the CPU; one intra-op thread each
# keeps torch's thread pools from oversubscribing it.
torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.core import se2 as jse2
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu.ops import psm as jpsm
from laser_slam_tpu.ops.pallas.psm_kernel import match_psm_pallas
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.core.scan import Scan
from laser_slam_tpu_torch.ops import psm as tpsm
from laser_slam_tpu_torch.ops.cuda import psm_kernel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

PRESETS = ["LMS211", "LMS511", "LMS151"]
POSE_ATOL = 1e-4    # float32 reduction order inside 15 solver iterations
ERR_RTOL = 1e-4
PALLAS_ATOL = 2e-3  # the Pallas-vs-XLA bound of tests/test_pallas_psm.py


def pair_batch(model, n, seed):
    """``n`` consecutive-looking pairs in the asymmetric test room, as
    numpy ranges ``[n, N]`` (ref, cur) and the true relative poses."""
    rng = np.random.default_rng(seed)
    p0 = np.stack(
        [rng.uniform(-1.0, 2.5, n), rng.uniform(-1.5, 2.0, n), rng.uniform(-np.pi, np.pi, n)], 1
    )
    rel = np.stack([rng.normal(0, 0.06, n), rng.normal(0, 0.06, n), rng.normal(0, 0.05, n)], 1)
    p1 = jse2.np_compose(p0, rel)
    walls = synthetic_log.room_walls()
    fi = np.asarray(model.bearings(), np.float64)
    out = []
    for p in (p0, p1):
        r = synthetic_log.ray_cast(walls, p, fi, model.max_range)
        out.append(np.where(r <= model.max_range, r + rng.normal(0, 0.01, r.shape), r)
                   .astype(np.float32))
    return out[0], out[1], rel


def both(name, n=8, seed=24):
    jm = jscan.PRESETS[name]
    tm = interop.model_from_fields(dataclasses.asdict(jm))
    ra, rb, rel = pair_batch(jm, n, seed)
    ja, jb = jpp.preprocess(jnp.asarray(ra), jm), jpp.preprocess(jnp.asarray(rb), jm)
    ta = interop.scan_from_numpy(*(np.asarray(x) for x in ja))
    tb = interop.scan_from_numpy(*(np.asarray(x) for x in jb))
    return jm, tm, ja, jb, ta, tb, rel


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("name", PRESETS)
def test_match_psm_matches_jax(name, with_init):
    jm, tm, ja, jb, ta, tb, rel = both(name)
    init = None
    if with_init:
        init = (rel + np.random.default_rng(21).normal(0, 0.02, rel.shape)).astype(np.float32)
        want = jax.jit(jax.vmap(lambda a, b, p: jpsm.match_psm(jm, a, b, p)))(
            ja, jb, jnp.asarray(init))
        got = tpsm.match_psm(tm, ta, tb, torch.from_numpy(init))
    else:
        want = jax.jit(jax.vmap(lambda a, b: jpsm.match_psm(jm, a, b)))(ja, jb)
        got = tpsm.match_psm(tm, ta, tb)
    np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=POSE_ATOL)
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err), rtol=ERR_RTOL)
    # The matcher finds the true motion on most pairs.
    assert not got.fail.any()
    assert np.median(np.abs(got.pose.numpy() - rel)) < 0.01


@pytest.mark.parametrize("name", PRESETS)
def test_error_index_matches_jax(name):
    jm, tm, ja, jb, ta, tb, rel = both(name, seed=22)
    rel = rel.astype(np.float32)
    want = jax.vmap(lambda a, b, p: jpsm.error_index(jm, a, b, p))(ja, jb, jnp.asarray(rel))
    got = tpsm.error_index(tm, ta, tb, torch.from_numpy(rel))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4, atol=1e-9)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # No overlapping beam at all reads as the worst error.
    far = torch.tensor([[30.0, 30.0, 0.0]] * rel.shape[0])
    ex, ey, n = tpsm.error_index(tm, ta, tb, far)
    assert (n == 0).all() and (ex == 1e6).all() and (ey == 1e6).all()


def test_plain_psm_vs_pallas_interpret(room):
    """The Pallas kernel (interpret mode) and the port's plain matcher on
    the LMS211 pairs of tests/test_pallas_psm.py."""
    model = jscan.LMS211
    tm = interop.model_from_fields(dataclasses.asdict(model))
    rng = np.random.default_rng(0)
    sa_l, sb_l = [], []
    for rel in [(0.05, 0.02, 0.03), (-0.1, 0.05, -0.05), (0.0, 0.0, 0.12)]:
        pa = (0.4, -0.3, 0.2)
        pb = tuple(np.asarray(jse2.compose(jnp.asarray(pa), jnp.asarray(rel))))
        sa_l.append(room(model, pa) + rng.normal(0, 0.003, model.n_beams).astype(np.float32))
        sb_l.append(room(model, pb) + rng.normal(0, 0.003, model.n_beams).astype(np.float32))
    ja = jpp.preprocess(jnp.asarray(np.stack(sa_l)), model)
    jb = jpp.preprocess(jnp.asarray(np.stack(sb_l)), model)
    pal = match_psm_pallas(model, ja, jb, interpret=True)
    got = tpsm.match_psm(tm, interop.scan_from_numpy(*(np.asarray(x) for x in ja)),
                         interop.scan_from_numpy(*(np.asarray(x) for x in jb)))
    assert not np.any(np.asarray(pal.fail)) and not got.fail.any()
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(pal.pose), atol=PALLAS_ATOL)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    _, tm, _, _, ta, tb, rel = both("LMS211", n=4, seed=23)
    before = psm_kernel.match_psm_fused.launches
    a = psm_kernel.match_psm_fused(tm, ta, tb)
    b = tpsm.match_psm(tm, ta, tb)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert psm_kernel.match_psm_fused.launches == before   # no kernel launched
    meta = Scan(*(x.to("meta") for x in ta))
    with pytest.raises(ValueError):
        psm_kernel.match_psm_fused(tm, meta, meta)


@pytest.mark.parametrize("name", PRESETS)
def test_fused_wrapper_with_error_ref_matches_jax(name):
    """``match_psm_fused(..., error_ref=last)`` on CPU tensors (the plain
    match plus the plain error index) against JAX's ``match_psm`` and
    ``error_index`` on the same numpy inputs; the error reference is
    another scan than the match reference, as in the keyframe step."""
    jm, tm, ja, jb, ta, tb, rel = both(name)
    init = (rel + np.random.default_rng(21).normal(0, 0.02, rel.shape)).astype(np.float32)
    # Each pair's error reference: the reference scan of the next pair.
    jl = jscan.Scan(*(jnp.roll(x, 1, axis=0) for x in ja))
    tl = Scan(*(torch.roll(x, 1, dims=0) for x in ta))
    want = jax.jit(jax.vmap(lambda a, b, p: jpsm.match_psm(jm, a, b, p)))(
        ja, jb, jnp.asarray(init))
    want_ei = jax.vmap(lambda a, b, p: jpsm.error_index(jm, a, b, p))(jl, jb, want.pose)
    before = psm_kernel.match_psm_fused.launches
    got, got_ei = psm_kernel.match_psm_fused(tm, ta, tb, torch.from_numpy(init), error_ref=tl)
    assert psm_kernel.match_psm_fused.launches == before   # CPU: plain versions
    np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=POSE_ATOL)
    # The error index is a mean over the beams that agree within 1 m at a
    # pose that differs by up to POSE_ATOL, hence rtol 1e-3.
    np.testing.assert_allclose(got_ei[0].numpy(), np.asarray(want_ei[0]), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(got_ei[1].numpy(), np.asarray(want_ei[1]), rtol=1e-3, atol=1e-9)
    np.testing.assert_array_equal(got_ei[2].numpy(), np.asarray(want_ei[2]))
    # It is the plain error index at the plain match's pose.
    plain = tpsm.error_index(tm, tl, tb, got.pose)
    for x, y in zip(got_ei, plain):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
