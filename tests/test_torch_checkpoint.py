"""Port parity: ``laser_slam_tpu_torch.utils.checkpoint`` writes and reads
the ``.npz`` format of ``laser_slam_tpu.utils.checkpoint`` key for key, so
a checkpoint of either package loads in the other (arrays equal
exactly: nothing is computed). The port's copies of the host-only
``timestamp`` and ``profiling`` utilities are held to the originals too.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.utils import checkpoint as jckpt
from laser_slam_tpu.utils import timestamp as jts
from laser_slam_tpu_torch import utils as tutils
from laser_slam_tpu_torch.utils import checkpoint as tckpt
from laser_slam_tpu_torch.utils import timestamp as tts


class Pair(NamedTuple):
    a: object
    b: object


def trees(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (4, 3)).astype(np.float32)
    m = rng.random(5) > 0.5
    i = rng.integers(0, 9, 6).astype(np.int32)

    def build(arr):
        return {"poses": arr(x), "flags": [arr(m), None], "carry": Pair(a=arr(i), b=Pair(arr(x[0]), None)),
                "count": 7, "nothing": None}

    return build(jnp.asarray), build(torch.from_numpy), (x, m, i)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_between_the_packages(tmp_path, writer):
    jtree, ttree, (x, m, i) = trees()
    path = str(tmp_path / "ckpt.npz")
    meta = {"t": 12, "model": "LMS211", "stride": 10}
    if writer == "jax":
        jckpt.save_pytree(path, jtree, meta=meta)
    else:
        tckpt.save_pytree(path, ttree, meta=meta)
    for load in (jckpt.load_pytree, tckpt.load_pytree):
        flat, got_meta = load(path)
        assert got_meta == meta
        assert sorted(flat) == ["carry/a", "carry/b/a", "carry/b/b", "count", "flags/0", "flags/1",
                                "nothing", "poses"]
        np.testing.assert_array_equal(flat["poses"], x)
        np.testing.assert_array_equal(flat["flags/0"], m)
        np.testing.assert_array_equal(flat["carry/a"], i)
        np.testing.assert_array_equal(flat["carry/b/a"], x[0])
        assert flat["poses"].dtype == np.float32 and flat["carry/a"].dtype == np.int32
        assert flat["flags/1"] is None and flat["nothing"] is None and flat["carry/b/b"] is None
        assert int(flat["count"]) == 7


def test_both_packages_write_the_same_file_keys(tmp_path):
    jtree, ttree, _ = trees(1)
    jckpt.save_pytree(str(tmp_path / "j.npz"), jtree)
    tckpt.save_pytree(str(tmp_path / "t.npz"), ttree)
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(a.files) == sorted(b.files) and "__meta_json__" in a.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


def test_timestamp_and_profiler_copies():
    for s in (0.0, 1.5, 1.7e9 + 0.1234567):
        assert tts.from_seconds(s) == jts.from_seconds(s)
        assert tts.to_seconds(tts.from_seconds(s)) == jts.to_seconds(jts.from_seconds(s))
    assert tts.diff_seconds(30_000_000, 10_000_000) == 2.0
    assert abs(tts.to_seconds(tutils.now()) - jts.to_seconds(jts.now())) < 5.0
    prof = tutils.Profiler()
    with prof.trace("off"):
        pass
    assert prof.report() == {}
    prof.enable()
    with prof.trace("step"):
        pass
    prof.record("step", 0.5)
    rep = prof.report()["step"]
    assert rep["count"] == 2 and rep["max"] == 0.5 and "step" in prof.summary()
