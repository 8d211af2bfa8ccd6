"""Port parity: the feature pipeline of ``laser_slam_tpu_torch``
(``features/``: the blob detector, the polar descriptor and its χ²
distance, RANSAC matching) and ``graph/loop_closure.verify_loops_features``
against ``laser_slam_tpu``, on scans of the synthetic floor plan (numpy
seed).

Random numbers: JAX's RANSAC draws its hypotheses with
``jax.random.categorical`` from a key per pair. The tests draw them the
same way and feed the indices to the port's deterministic halves
(``match_features_at``, ``verify_loops_features_at``); the port's own
draws come from an explicit ``torch.Generator``.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu import features as jf
from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.graph import loop_closure as jlc
from laser_slam_tpu.ops import odometry as jodo
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu_torch import features as tf
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.graph import loop_closure as tlc

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
N_SCANS = 300
XY_ATOL = 1e-4        # [m] a feature's position (float32 cos/sin of its range)
SCORE_ATOL = 1e-5     # detector response
POSE_ATOL = 1e-4      # [m, rad] a RANSAC pose from the same draws
# Features present in one package's set only: a float32 sum-order
# difference of the smoothing convolution (XLA's against ATen's) can flip
# an extremum or threshold test on a borderline response.
MAX_DIFFERING_FEATURES = 0.005
# Descriptor distances that are equal in exact arithmetic (histograms of a
# few points: 1/3, 3/13, ...) come out of the 32-bin χ² sum a last bit
# apart in one package and equal in the other, so a feature's best match
# may be another equally distant feature. Results are held exactly on the
# pairs whose candidate correspondences agree, and those must be most.
MIN_SAME_CORRESPONDENCES = 0.75


@pytest.fixture(scope="module")
def data():
    """JAX's preprocessed scans and keyframe odometry of 300 scans, its
    anchors (every 10th scan) and their features, as numpy."""
    ranges, _, ts = synthetic_log.synthetic_log(n_scans=N_SCANS, n_whips=0)
    ranges = np.concatenate([ranges, np.full((N_SCANS, 1), MODEL.max_range + 1.0, np.float32)], 1)
    js = jpp.preprocess(jnp.asarray(ranges), MODEL)
    poses = jodo.odometry_keyframe(MODEL, js, timestamps=ts).poses
    aidx = np.arange(0, N_SCANS, 10)
    sc = jscan.Scan(*(x[aidx] for x in js))
    feats = jax.vmap(lambda s: jf.detect_features(MODEL, s))(sc)
    descs = jax.vmap(lambda s, f: jf.describe_features(MODEL, s, f))(sc, feats)
    return dict(scans=tuple(np.asarray(x) for x in js), anchor_scans=tuple(np.asarray(x) for x in sc),
                anchor_poses=np.asarray(poses)[aidx],
                feats={k: np.asarray(v) for k, v in feats._asdict().items()}, descs=np.asarray(descs))


def port_feats(d):
    return interop.named_state_from_numpy(tf.FeatureSet, d["feats"])


def test_detect_features_matches_jax(data):
    """All 300 scans: the same fixed-shape sets up to borderline features;
    the features in both sets at the same position and response."""
    scans = data["scans"]
    want = jax.vmap(lambda s: jf.detect_features(MODEL, s))(jscan.Scan(*(jnp.asarray(x) for x in scans)))
    got = tf.detect_features(TMODEL, interop.scan_from_numpy(*scans))
    assert got.xy.shape == (N_SCANS, tf.detector.MAX_FEATURES, 2) and got.beam.dtype == torch.int32
    w = {k: np.asarray(v) for k, v in want._asdict().items()}
    g = {k: v.numpy() for k, v in got._asdict().items()}
    n_diff = n_all = 0
    for b in range(N_SCANS):
        key = lambda f: {(int(i), float(s)): k for k, (i, s, ok) in         # noqa: E731
                         enumerate(zip(f["beam"][b], f["scale"][b], f["valid"][b])) if ok}
        kg, kw = key(g), key(w)
        n_all += len(kw)
        n_diff += len(kg.keys() ^ kw.keys())
        both = sorted(kg.keys() & kw.keys())
        ig, iw = [kg[k] for k in both], [kw[k] for k in both]
        np.testing.assert_allclose(g["xy"][b][ig], w["xy"][b][iw], atol=XY_ATOL)
        np.testing.assert_allclose(g["score"][b][ig], w["score"][b][iw], atol=SCORE_ATOL)
        assert not g["valid"][b][len(kg):].any() and (g["beam"][b][~g["valid"][b]] == -1).all()
    assert n_all > 10 * N_SCANS and n_diff <= MAX_DIFFERING_FEATURES * n_all, (n_diff, n_all)


def test_describe_features_and_distance_match_jax(data):
    """JAX's features carried across: the same descriptors and distances."""
    sc = interop.scan_from_numpy(*data["anchor_scans"])
    got = tf.describe_features(TMODEL, sc, port_feats(data))
    np.testing.assert_allclose(got.numpy(), data["descs"], atol=1e-6)
    valid = data["feats"]["valid"]
    sums = got.sum(-1).numpy()
    assert np.allclose(sums[valid], 1.0, atol=1e-5) and (sums[~valid] == 0).all()
    want = jax.vmap(jf.descriptor_distance)(jnp.asarray(data["descs"][:-1]), jnp.asarray(data["descs"][1:]))
    dist = tf.descriptor_distance(got[:-1], got[1:])
    np.testing.assert_allclose(dist.numpy(), np.asarray(want), atol=1e-6)


def jax_draws(fa, da, fb, db, keys, n_hypotheses=jf.ransac.N_HYPOTHESES):
    """The hypothesis indices JAX's ``match_features`` draws from ``keys``
    (one per pair): the same candidate weights and the same two
    categorical draws, as numpy ``[C, H]``."""
    def one(fa, da, fb, db, key):
        dist = jf.descriptor_distance(db, da)
        dist = jnp.where(fb.valid[:, None] & fa.valid[None, :], dist, jnp.inf)
        d_best = jnp.min(dist, axis=1)
        corr_ok = jnp.isfinite(d_best) & (d_best < jf.ransac.DESC_MATCH_THRESH)
        w = corr_ok.astype(fa.xy.dtype) + 1e-6
        logits = jnp.log(w / jnp.sum(w))
        k1, k2 = jax.random.split(key)
        return (jax.random.categorical(k1, logits, shape=(n_hypotheses,)),
                jax.random.categorical(k2, logits, shape=(n_hypotheses,)))

    i1, i2 = jax.vmap(one)(fa, da, fb, db, keys)
    return torch.from_numpy(np.asarray(i1, np.int64)), torch.from_numpy(np.asarray(i2, np.int64))


def same_correspondences(jpair, tpair):
    """Per pair: do both packages pick the same best match for every
    feature of B that has one?"""
    def one(fa, da, fb, db):
        dist = jnp.where(fb.valid[:, None] & fa.valid[None, :], jf.descriptor_distance(db, da), jnp.inf)
        d_best = jnp.min(dist, axis=1)
        return jnp.argmin(dist, axis=1), jnp.isfinite(d_best) & (d_best < jf.ransac.DESC_MATCH_THRESH)

    jb, jok = (np.asarray(x) for x in jax.vmap(one)(*jpair))
    tb, tok, _ = tf.ransac.candidate_correspondences(*tpair)
    np.testing.assert_array_equal(tok.numpy(), jok)
    return np.all((tb.numpy() == jb) | ~jok, axis=1)


def pairs_of(data, src, dst):
    f = data["feats"]
    jfs = jf.FeatureSet(**{k: jnp.asarray(v) for k, v in f.items()})
    pick = lambda fs, i: type(fs)(*(x[i] for x in fs))                         # noqa: E731
    tfs = port_feats(data)
    d = data["descs"]
    return ((pick(jfs, src), jnp.asarray(d[src]), pick(jfs, dst), jnp.asarray(d[dst])),
            (pick(tfs, src), torch.from_numpy(d[src]), pick(tfs, dst), torch.from_numpy(d[dst])))


def test_match_features_matches_jax_with_its_draws(data):
    """Consecutive anchors and anchors a lap apart, JAX's features and
    draws: the same best hypothesis, inliers, refined pose and error."""
    src = np.concatenate([np.arange(0, 29), [10, 11, 12, 13]])
    dst = np.concatenate([np.arange(1, 30), [26, 25, 24, 23]])
    jpair, tpair = pairs_of(data, src, dst)
    keys = jax.random.split(jax.random.PRNGKey(3), src.size)
    want = jax.vmap(jf.match_features)(*jpair, keys)
    got = tf.match_features_at(*tpair, *jax_draws(*jpair, keys))
    same = same_correspondences(jpair, tpair)
    assert same.mean() >= MIN_SAME_CORRESPONDENCES, same.mean()
    want = type(want)(*(np.asarray(x)[same] for x in want))
    got = type(got)(*(x[torch.from_numpy(same)] for x in got))
    np.testing.assert_array_equal(got.n_inliers.numpy(), want.n_inliers)
    np.testing.assert_array_equal(got.fail.numpy(), want.fail)
    ok = ~got.fail.numpy()
    assert ok.sum() >= 15
    np.testing.assert_allclose(got.pose.numpy(), want.pose, atol=POSE_ATOL)
    np.testing.assert_allclose(got.err.numpy()[ok], np.asarray(want.err)[ok], atol=1e-5)
    np.testing.assert_allclose(got.information.numpy()[ok], np.asarray(want.information)[ok], rtol=1e-3)
    assert np.isinf(got.err.numpy()[~ok]).all()
    # The port's own draws: reproducible from the generator's seed.
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        outs.append(tf.match_features(*tpair, gen))
    assert torch.equal(outs[0].pose, outs[1].pose) and (~outs[0].fail).sum() >= 20


def test_verify_loops_features_matches_jax(data):
    """Candidates between anchors one and two apart (0.7-1.4 m: most
    verify) and across the lap (none verifies), one of them invalid; JAX's
    draws (a key per candidate, split from one seed). The port detects and
    describes the anchors itself: on the pairs whose two anchors have the
    same feature sets and correspondences in both packages, the same
    loops, relative poses and qualities."""
    src = np.concatenate([np.arange(0, 29), np.arange(0, 28), [10, 11, 12, 13]])
    dst = np.concatenate([np.arange(1, 30), np.arange(2, 30), [26, 25, 24, 23]])
    valid = np.ones(src.size, bool)
    valid[3] = False
    fields = dict(src=src.astype(np.int32), dst=dst.astype(np.int32), valid=valid)
    sc = jscan.Scan(*(jnp.asarray(x) for x in data["anchor_scans"]))
    ap = jnp.asarray(data["anchor_poses"])
    want = jlc.verify_loops_features(MODEL, sc, ap, jlc.LoopCandidates(**{
        k: jnp.asarray(v) for k, v in fields.items()}), seed=0)
    keys = jax.random.split(jax.random.PRNGKey(0), src.size)
    jpair, tpair = pairs_of(data, src, dst)
    tsc = interop.scan_from_numpy(*data["anchor_scans"])
    tap = torch.from_numpy(data["anchor_poses"])
    tcand = interop.state_from_numpy(tlc.LoopCandidates, fields)
    got = tlc.verify_loops_features_at(TMODEL, tsc, tap, tcand, *jax_draws(*jpair, keys))
    own = tf.detect_features(TMODEL, tsc)
    same = np.all(own.beam.numpy() == data["feats"]["beam"], axis=1)
    pair_same = same[src] & same[dst] & same_correspondences(jpair, tpair)
    assert pair_same.mean() >= MIN_SAME_CORRESPONDENCES, pair_same.mean()
    acc = np.asarray(want.accept)
    np.testing.assert_array_equal(got.accept.numpy()[pair_same], acc[pair_same])
    np.testing.assert_allclose(got.rel.numpy()[pair_same], np.asarray(want.rel)[pair_same], atol=POSE_ATOL)
    np.testing.assert_allclose(got.quality.numpy()[pair_same], np.asarray(want.quality)[pair_same],
                               atol=1e-6)
    assert acc[pair_same].sum() >= 8 and not acc[3] and not acc[-4:].any()
    # The verifier with its own draws: the loops between near anchors.
    out = tlc.verify_loops_features(TMODEL, tsc, tap, tcand, torch.Generator().manual_seed(0))
    assert out.accept.sum() >= 8 and not out.accept[3]
