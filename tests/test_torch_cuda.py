"""The fused PSM CUDA kernel (K1) against the plain PyTorch matcher on the
card. These tests need a CUDA device and skip without one; they import no
jax, so that they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from laser_slam_tpu_torch.core import scan as S
from laser_slam_tpu_torch.core import se2
from laser_slam_tpu_torch.ops import preprocess as pp
from laser_slam_tpu_torch.ops import psm
from laser_slam_tpu_torch.ops.cuda import psm_kernel

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

POSE_ATOL = 1e-4    # float32 op order (fused multiply-adds, block reductions)
ERR_RTOL = 1e-4

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def pairs(model, n, seed, dev):
    """``n`` pairs in the asymmetric test room, preprocessed on ``dev``."""
    rng = np.random.default_rng(seed)
    p0 = np.stack([rng.uniform(-1.0, 2.5, n), rng.uniform(-1.5, 2.0, n),
                   rng.uniform(-np.pi, np.pi, n)], 1)
    rel = np.stack([rng.normal(0, 0.06, n), rng.normal(0, 0.06, n), rng.normal(0, 0.05, n)], 1)
    fi = model.bearings(torch.float64).numpy()
    out = []
    for p in (p0, se2.np_compose(p0, rel)):
        r = synthetic_log.ray_cast(synthetic_log.room_walls(), p, fi, model.max_range)
        r = np.where(r <= model.max_range, r + rng.normal(0, 0.01, r.shape), r)
        out.append(pp.preprocess(torch.as_tensor(r, dtype=torch.float32, device=dev), model))
    return out[0], out[1], rel


@pytest.mark.parametrize("batch", [2, 64])
@pytest.mark.parametrize("name", ["LMS211", "LMS511", "LMS151"])
def test_fused_kernel_matches_plain(cuda, name, batch):
    model = S.PRESETS[name]
    ref, cur, rel = pairs(model, batch, 24, cuda)
    init = torch.as_tensor(rel * 0.5, dtype=torch.float32, device=cuda)
    before = psm_kernel.match_psm_fused.launches
    k = psm_kernel.match_psm_fused(model, ref, cur, init)
    p = psm.match_psm(model, ref, cur, init)
    torch.cuda.synchronize()
    assert psm_kernel.match_psm_fused.launches == before + 1
    np.testing.assert_array_equal(k.fail.cpu().numpy(), p.fail.cpu().numpy())
    np.testing.assert_allclose(k.pose.cpu().numpy(), p.pose.cpu().numpy(), atol=POSE_ATOL)
    np.testing.assert_allclose(k.err.cpu().numpy(), p.err.cpu().numpy(), rtol=ERR_RTOL)


def test_fused_kernel_rejects_what_it_does_not_take(cuda):
    model = S.LMS211
    ref, cur, _ = pairs(model, 4, 25, cuda)
    before = psm_kernel.match_psm_fused.launches
    with pytest.raises(ValueError):    # float64 ranges
        psm_kernel.match_psm_fused(model, ref._replace(ranges=ref.ranges.double()), cur)
    with pytest.raises(ValueError):    # a beam count the model does not have
        psm_kernel.match_psm_fused(S.LMS511, ref, cur)
    with pytest.raises(ValueError):    # inputs on two devices
        psm_kernel.match_psm_fused(model, ref.to("cpu"), cur)
    assert psm_kernel.match_psm_fused.launches == before
