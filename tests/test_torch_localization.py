"""Port parity: ``localization/raycast`` and ``localization/particle_filter``
against the JAX package on a box-room map, inputs made with numpy.

Random numbers. ``jax.random`` streams cannot be reproduced by a
``torch.Generator``, so every sampling function of the port is split into
its draw and a deterministic part. The parity tests draw with
``jax.random`` exactly as the JAX function does (the same ``split``s) and
hand those draws to the port's deterministic part: clouds 1e-5, resampled
indices equal. The port's own draws are held statistically, seed fixed.

Cell indices. The JAX functions are called eagerly (or under ``vmap``
alone), where ``floor((x - origin) / resolution)`` is a true division; the
port divides too. So both packages read the same cells, except where
their float32 ``cos``/``sin`` differ in the last bit and an endpoint lies
on a cell edge; each test says how it allows for that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.localization import particle_filter as jpf
from laser_slam_tpu.localization import raycast as jrc
from laser_slam_tpu.mapping import occupancy as jocc
from laser_slam_tpu.ops import icp_points as jicp
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.localization import particle_filter as tpf
from laser_slam_tpu_torch.localization import raycast as trc

from tests.conftest import box_room_ranges

MODEL = dataclasses.replace(jscan.LMS211, max_range=12.0)
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
BOX = (-3.0, 5.0, -4.0, 4.0)
ATOL = 1e-5


@pytest.fixture(scope="module")
def room_map():
    """One grid, the same log-odds in both packages, its likelihood
    fields, and a scan from a known pose."""
    poses = np.array(
        [[0, 0, 0], [1, 0, 0.4], [1, 1, 0.9], [0.2, 1.2, 1.8], [-0.5, 0.3, 2.6],
         [0.5, -0.8, -1.2], [1.5, 0.5, 0.2], [-1.0, -1.0, 0.7]], dtype=np.float32)
    ranges = np.stack([box_room_ranges(MODEL, p, BOX) for p in poses])
    scans = jpp.preprocess(jnp.asarray(ranges), MODEL)
    spec = jocc.GridSpec2D(-5.0, -6.0, 0.05, 220, 220)
    jgrid = jocc.integrate_scans(jocc.empty_grid(spec), MODEL, scans, jnp.asarray(poses))
    tgrid = interop.grid_from_numpy(np.asarray(jgrid.log_odds), dataclasses.asdict(spec))
    true_pose = np.asarray([0.5, 0.2, 0.3], np.float32)
    obs = box_room_ranges(MODEL, true_pose, BOX)
    valid = obs < MODEL.max_range
    return {"jgrid": jgrid, "tgrid": tgrid, "jfield": jrc.likelihood_field(jgrid),
            "tfield": trc.likelihood_field(tgrid), "true": true_pose,
            "obs": obs, "valid": valid}


def cloud(n=256, seed=0, spread=(0.3, 0.3, 0.2)):
    rng = np.random.default_rng(seed)
    poses = (np.asarray([0.5, 0.2, 0.3]) + rng.normal(0, 1, (n, 3)) * spread).astype(np.float32)
    log_w = rng.normal(0, 1.5, n).astype(np.float32)
    log_w -= np.log(np.exp(log_w).sum())
    return poses, log_w


def both_states(poses, log_w):
    return (jpf.ParticleState(jnp.asarray(poses), jnp.asarray(log_w)),
            interop.named_state_from_numpy(tpf.ParticleState, {"poses": poses, "log_w": log_w}))


def check_state(t_state, j_state, atol=ATOL):
    got = interop.named_state_to_numpy(t_state)
    np.testing.assert_allclose(got["poses"], np.asarray(j_state.poses), atol=atol)
    np.testing.assert_allclose(got["log_w"], np.asarray(j_state.log_w), atol=atol)


# -- raycast -------------------------------------------------------------

def test_likelihood_field_matches_jax(room_map):
    """The min-plus relaxation is adds and mins of the same float32
    numbers, so the distances are exact and the field differs only by
    ``exp``: 1e-6."""
    jf, tf = np.asarray(room_map["jfield"]), room_map["tfield"].numpy()
    np.testing.assert_allclose(tf, jf, atol=1e-6)
    assert tf.max() == 1.0 and 0.0 < (tf < 1e-3).mean() < 1.0
    for sigma, n_iter in ((0.1, None), (0.2, 3)):
        np.testing.assert_allclose(
            trc.likelihood_field(room_map["tgrid"], sigma, n_iter).numpy(),
            np.asarray(jrc.likelihood_field(room_map["jgrid"], sigma, n_iter)), atol=1e-6)


def test_simulate_scan_matches_jax(room_map):
    """One pose and a batch of poses against JAX's ``simulate_scan``
    (``vmap`` for the batch). A ray sample on a cell edge may read the
    neighbouring cell where ``cos``/``sin`` differ in the last bit, which
    moves that beam's first hit by one sample or more; on this fixture no
    beam differs, and at most 1 in 500 may."""
    poses, _ = cloud(24, seed=4, spread=(1.0, 1.0, 1.5))
    want = np.asarray(jax.vmap(lambda p: jrc.simulate_scan(room_map["jgrid"], MODEL, p))(
        jnp.asarray(poses)))
    got = trc.simulate_scan(room_map["tgrid"], TMODEL, torch.from_numpy(poses)).numpy()
    assert got.shape == want.shape == (24, MODEL.n_beams)
    differ = np.abs(got - want) > 1e-6
    assert differ.mean() <= 0.002, f"{differ.sum()} beams differ"
    one = trc.simulate_scan(room_map["tgrid"], TMODEL, torch.from_numpy(poses[3])).numpy()
    np.testing.assert_array_equal(one, got[3])
    # Shorter range and another threshold: the arguments reach the march.
    got = trc.simulate_scan(room_map["tgrid"], TMODEL, torch.from_numpy(poses[:4]), max_range=3.0,
                            occ_threshold=0.7).numpy()
    want = np.asarray(jax.vmap(lambda p: jrc.simulate_scan(
        room_map["jgrid"], MODEL, p, max_range=3.0, occ_threshold=0.7))(jnp.asarray(poses[:4])))
    assert (np.abs(got - want) > 1e-6).mean() <= 0.002 and got.max() == 3.0


def test_beam_and_endpoint_likelihood_match_jax(room_map):
    poses, _ = cloud(64, seed=5)
    obs, valid = room_map["obs"], room_map["valid"]
    jl = jax.vmap(lambda p: jrc.beam_likelihood(room_map["jgrid"], MODEL, p, jnp.asarray(obs),
                                                jnp.asarray(valid)))(jnp.asarray(poses))
    tl = trc.beam_likelihood(room_map["tgrid"], TMODEL, torch.from_numpy(poses),
                             torch.from_numpy(obs), torch.from_numpy(valid))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    # Endpoints: an endpoint on a cell edge may read the neighbouring
    # cell's field value; the mean over ~180 beams then moves by up to
    # 1/180 of a field step. Held to 1e-5 on all but 2 % of the poses,
    # and to 5e-3 everywhere.
    je = jax.vmap(lambda p: jrc.endpoint_likelihood(
        room_map["jfield"], room_map["jgrid"].spec, MODEL, p, jnp.asarray(obs),
        jnp.asarray(valid)))(jnp.asarray(poses))
    te = trc.endpoint_likelihood(room_map["tfield"], room_map["tgrid"].spec, TMODEL,
                                 torch.from_numpy(poses), torch.from_numpy(obs),
                                 torch.from_numpy(valid))
    d = np.abs(te.numpy() - np.asarray(je))
    assert (d > ATOL).mean() <= 0.02 and d.max() < 5e-3, (d > ATOL).sum()


# -- particle filter, JAX's draws -----------------------------------------

def test_init_and_predict_with_jax_draws_match_jax():
    key = jax.random.PRNGKey(3)
    pose = np.asarray([0.5, -0.25, 3.0], np.float32)
    kx, kt = jax.random.split(key)
    nxy, nt = np.array(jax.random.normal(kx, (128, 2))), np.array(jax.random.normal(kt, (128,)))
    js = jpf.init_gaussian(key, jnp.asarray(pose), 128)
    ts = tpf.init_from_noise(torch.from_numpy(pose), torch.from_numpy(nxy), torch.from_numpy(nt))
    check_state(ts, js)
    assert (np.abs(np.asarray(js.poses[:, 2])) <= np.pi).all()     # wrapped past pi
    key2 = jax.random.PRNGKey(4)
    kx, kt = jax.random.split(key2)
    nxy, nt = np.array(jax.random.normal(kx, (128, 2))), np.array(jax.random.normal(kt, (128,)))
    rel = np.asarray([0.1, -0.02, 0.05], np.float32)
    check_state(
        tpf.predict_with_noise(ts, torch.from_numpy(rel), torch.from_numpy(nxy),
                               torch.from_numpy(nt), sigma_xy=0.05, sigma_theta=0.03),
        jpf.predict(js, jnp.asarray(rel), key2, sigma_xy=0.05, sigma_theta=0.03))


def test_weight_updates_match_jax(room_map):
    poses, log_w = cloud(96, seed=6)
    js, ts = both_states(poses, log_w)
    obs, valid = room_map["obs"], room_map["valid"]
    jo, jv = jnp.asarray(obs), jnp.asarray(valid)
    to, tv = torch.from_numpy(obs), torch.from_numpy(valid)
    # update_field: log-weights, with the edge-cell allowance of the
    # endpoint model (log of a likelihood of order 0.1-1: 5e-2 at worst).
    jf = jpf.update_field(js, room_map["jfield"], room_map["jgrid"], MODEL, jo, jv)
    tf = tpf.update_field(ts, room_map["tfield"], room_map["tgrid"], TMODEL, to, tv)
    d = np.abs(tf.log_w.numpy() - np.asarray(jf.log_w))
    assert (d > 1e-4).mean() <= 0.03 and d.max() < 5e-2
    np.testing.assert_array_equal(tf.poses.numpy(), poses)
    # update_beam: chunked (5 chunks of 20 and a rest) and in one piece.
    jb = jpf.update_beam(js, room_map["jgrid"], MODEL, jo, jv, sigma=0.4)
    tb = tpf.update_beam(ts, room_map["tgrid"], TMODEL, to, tv, sigma=0.4, chunk=20)
    check_state(tb, jb, atol=1e-4)
    whole = tpf.update_beam(ts, room_map["tgrid"], TMODEL, to, tv, sigma=0.4)
    np.testing.assert_allclose(tb.log_w.numpy(), whole.log_w.numpy(), atol=1e-6)
    assert tpf._chunk(4096, 181 * 1000 * trc.SIMULATE_BYTES_PER_SAMPLE, None) == \
        tpf.CHUNK_BYTES // (181 * 1000 * trc.SIMULATE_BYTES_PER_SAMPLE) < 4096


def test_update_icp_matches_jax(room_map):
    """The ICP update: JAX's ``occupied_points`` cloud on both sides, 24
    particles near the truth. ICP iterates a nearest-neighbour search, so
    round-off can move a correspondence; poses are held to 1e-3 and
    log-weights to 1e-2, the fail flags through the weights."""
    map_pts, map_ok = jocc.occupied_points(room_map["jgrid"], 1024)
    scan = jpp.preprocess(jnp.asarray(room_map["obs"])[None], MODEL)
    spts, sok = jicp.scan_to_points(MODEL, jax.tree.map(lambda x: x[0], scan))
    poses, log_w = cloud(24, seed=8, spread=(0.15, 0.15, 0.08))
    js, ts = both_states(poses, log_w)
    args = [torch.from_numpy(np.array(x)) for x in (map_pts, map_ok)] + [TMODEL] + \
        [torch.from_numpy(np.array(x)) for x in (spts, sok)]
    for nudge in (True, False):
        jr = jpf.update_icp(js, map_pts, map_ok, MODEL, spts, sok, nudge=nudge)
        tr = tpf.update_icp(ts, *args, nudge=nudge, chunk=10)
        np.testing.assert_allclose(tr.poses.numpy(), np.asarray(jr.poses), atol=1e-3)
        np.testing.assert_allclose(tr.log_w.numpy(), np.asarray(jr.log_w), atol=1e-2)
    np.testing.assert_array_equal(tr.poses.numpy(), poses)          # nudge=False
    assert np.abs(np.asarray(jpf.update_icp(js, map_pts, map_ok, MODEL, spts, sok).poses)
                  - poses).max() > 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resampling_with_jax_draws_matches_jax(seed):
    poses, log_w = cloud(512, seed=10 + seed)
    js, ts = both_states(poses, log_w)
    key = jax.random.PRNGKey(seed)
    u = float(jax.random.uniform(key, ()))
    jr = jpf.systematic_resample(js, key)
    tr = tpf.systematic_resample_at(ts, u)
    # Indices equal: every resampled pose is the same row of the cloud.
    np.testing.assert_array_equal(tr.poses.numpy(), np.asarray(jr.poses))
    np.testing.assert_allclose(tr.log_w.numpy(), np.asarray(jr.log_w), atol=1e-6)
    np.testing.assert_allclose(float(tpf.neff(ts)), float(jpf.neff(js)), rtol=1e-5)
    # maybe_resample: this cloud is degenerate enough to resample ...
    assert float(jpf.neff(js)) < 0.5 * 512
    check_state(tpf.maybe_resample_at(ts, u), jpf.maybe_resample(js, key), atol=1e-6)
    # ... and a uniform one is left alone.
    flat = np.full(512, -np.log(512.0), np.float32)
    js2, ts2 = both_states(poses, flat)
    check_state(tpf.maybe_resample_at(ts2, u), jpf.maybe_resample(js2, key), atol=0)
    np.testing.assert_array_equal(tpf.maybe_resample_at(ts2, u).poses.numpy(), poses)


def test_estimate_and_dispersion_rank_ties_like_jax():
    """Right after a resample every log-weight is equal: ``lax.top_k``
    then keeps the lowest indices, and so must the port."""
    poses, log_w = cloud(300, seed=20)
    for lw in (log_w, np.full(300, -np.log(300.0), np.float32),
               np.where(np.arange(300) % 3 == 0, np.float32(-2.0), np.float32(-7.0))):
        js, ts = both_states(poses, lw.astype(np.float32))
        for k in (8, 64, 500):
            np.testing.assert_allclose(tpf.estimate(ts, k).numpy(), np.asarray(jpf.estimate(js, k)),
                                       atol=ATOL)
            np.testing.assert_allclose(float(tpf.dispersion(ts, k)), float(jpf.dispersion(js, k)),
                                       atol=ATOL)
    flat = both_states(poses, np.full(300, -np.log(300.0), np.float32))[1]
    want = poses[:8].astype(np.float64)
    np.testing.assert_allclose(tpf.estimate(flat).numpy()[:2], want[:, :2].mean(0), atol=1e-5)


def test_global_relocalize_with_jax_draws_matches_jax(room_map):
    """JAX's 4,000 uniform samples into the port's deterministic part.
    Most samples lie outside free space and score exactly 0, so the cut
    at ``n_keep`` falls inside a tie when few score: both cases run."""
    key = jax.random.PRNGKey(5)
    spec = room_map["jgrid"].spec
    kx, ky, kt = jax.random.split(key, 3)
    n = 4000
    x = jax.random.uniform(kx, (n,), minval=spec.origin_x,
                           maxval=spec.origin_x + spec.width * spec.resolution)
    y = jax.random.uniform(ky, (n,), minval=spec.origin_y,
                           maxval=spec.origin_y + spec.height * spec.resolution)
    th = jax.random.uniform(kt, (n,), minval=-jnp.pi, maxval=jnp.pi)
    samples = torch.from_numpy(np.stack([np.asarray(x), np.asarray(y), np.asarray(th)], -1).copy())
    obs, valid = room_map["obs"], room_map["valid"]
    n_free = None
    for n_keep in (256, 3000):
        js = jpf.global_relocalize(key, room_map["jgrid"], room_map["jfield"], MODEL,
                                   jnp.asarray(obs), jnp.asarray(valid), n_samples=n, n_keep=n_keep)
        ts = tpf.global_relocalize_poses(samples, room_map["tgrid"], room_map["tfield"], TMODEL,
                                         torch.from_numpy(obs), torch.from_numpy(valid), n_keep=n_keep)
        jw, tw = np.asarray(js.log_w), ts.log_w.numpy()
        n_free = int((jw > jw.min() + 1e-3).sum())
        # The zero-score tail is a tie: the same samples in the same order.
        tail = jw <= jw.min() + 1e-6
        np.testing.assert_array_equal(ts.poses.numpy()[tail], np.asarray(js.poses)[tail])
        # The scored head: the same set of samples; two whose scores differ
        # in the last bits (an endpoint on a cell edge) may swap ranks.
        head = ~tail
        assert set(map(tuple, ts.poses.numpy()[head].round(5))) == \
            set(map(tuple, np.asarray(js.poses)[head].round(5)))
        np.testing.assert_allclose(np.sort(tw), np.sort(jw), atol=5e-2)
    assert 256 < n_free < 3000       # one cut above the tie, one inside it


def test_kld_sampling_matches_jax():
    poses, log_w = cloud(512, seed=30, spread=(2.0, 2.0, 1.0))
    poses[:, :2] *= 40.0             # bins far out, so that the int32 hash wraps
    log_w[400:] = -np.inf
    js, ts = both_states(poses, log_w)
    assert int(tpf.kld_sample_size(ts)) == int(jpf.kld_sample_size(js))
    assert tpf.kld_sample_size(ts).dtype == torch.int32
    bx = np.floor(poses[:, 0] / tpf.KLD_BIN_XY).astype(np.int64)
    assert np.abs(bx * 73856093).max() > 2 ** 31            # the hash does wrap
    tight, _ = cloud(512, seed=31, spread=(0.05, 0.05, 0.01))
    js2, ts2 = both_states(tight, np.full(512, -np.log(512.0), np.float32))
    assert int(tpf.kld_sample_size(ts2)) == int(jpf.kld_sample_size(js2)) < 200    # few bins
    key = jax.random.PRNGKey(2)
    u = float(jax.random.uniform(key, ()))
    log_w[400:] = -20.0
    js, ts = both_states(poses, log_w - np.log(np.exp(log_w).sum()))
    jr, tr = jpf.kld_resample(js, key), tpf.kld_resample_at(ts, u)
    np.testing.assert_array_equal(tr.poses.numpy(), np.asarray(jr.poses))
    np.testing.assert_array_equal(np.isfinite(tr.log_w.numpy()), np.isfinite(np.asarray(jr.log_w)))
    live = np.isfinite(tr.log_w.numpy())
    np.testing.assert_allclose(tr.log_w.numpy()[live], np.asarray(jr.log_w)[live], atol=1e-6)


# -- the port's own draws --------------------------------------------------

def test_own_draws_come_from_the_generator_and_have_the_right_spread(room_map):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    state_before = torch.get_rng_state()
    pose = torch.tensor([1.0, -2.0, 0.5])
    s = tpf.init_gaussian(gen, pose, 4000)
    assert s.poses.shape == (4000, 3) and s.poses.dtype == torch.float32
    np.testing.assert_allclose(s.poses.mean(0).numpy(), pose.numpy(), atol=0.02)
    np.testing.assert_allclose(s.poses.std(0).numpy(), [0.25, 0.25, 0.15], rtol=0.05)
    np.testing.assert_allclose(float(tpf.neff(s)), 4000.0, rtol=1e-4)
    p = tpf.predict(s, torch.tensor([0.5, 0.0, 0.0]), gen, sigma_xy=0.05, sigma_theta=0.03)
    moved = (p.poses - s.poses)[:, :2].norm(dim=-1)
    assert abs(float(moved.mean()) - 0.5) < 0.02
    # Resampling a cloud with one heavy particle keeps it about P·w times.
    lw = torch.full((4000,), -12.0)
    lw[17] = 0.0
    heavy = tpf.ParticleState(s.poses, tpf._normalize(lw))
    r = tpf.systematic_resample(heavy, gen)
    share = float((r.poses == s.poses[17]).all(dim=1).float().mean())
    assert abs(share - float(torch.exp(heavy.log_w[17]))) < 1e-3
    once = tpf.maybe_resample(heavy, gen)
    r2 = tpf.kld_resample(once, gen)
    assert int(torch.isfinite(r2.log_w).sum()) == int(tpf.kld_sample_size(once)) < 4000
    # Global relocalization: samples over the whole grid, the best kept.
    obs, valid = torch.from_numpy(room_map["obs"]), torch.from_numpy(room_map["valid"])
    g = tpf.global_relocalize(gen, room_map["tgrid"], room_map["tfield"], TMODEL, obs, valid,
                              n_samples=6000, n_keep=64)
    assert g.poses.shape == (64, 3) and (g.log_w[:-1] >= g.log_w[1:]).all()
    # The room is a plain box, so its symmetric aliases score as well as
    # the truth: held is that every kept sample lies in the room's free
    # space and explains the scan better than a uniform sample does.
    kept = g.poses.numpy()
    assert (kept[:, 0] > BOX[0]).all() and (kept[:, 0] < BOX[1]).all()
    assert (kept[:, 1] > BOX[2]).all() and (kept[:, 1] < BOX[3]).all()
    lik = trc.endpoint_likelihood(room_map["tfield"], room_map["tgrid"].spec, TMODEL, g.poses, obs, valid)
    assert float(lik.min()) > 0.2
    # The same seed gives the same cloud; the global generator is untouched.
    gen2 = torch.Generator(device="cpu")
    gen2.manual_seed(7)
    assert torch.equal(tpf.init_gaussian(gen2, pose, 4000).poses, s.poses)
    assert torch.equal(torch.get_rng_state(), state_before)
