"""Monte-Carlo localization: a batched particle cloud (port of
``localization/particle_filter.py``).

The whole cloud (thousands of particles) evaluates in one batched call
using any of four observation models:

- ``field``: likelihood-field endpoint model (one gather per beam, the
  fastest),
- ``beam``: ray-cast Gaussian beam model,
- ``icp``: per-particle trimmed point-ICP refinement against the map
  cloud with goodness weights and pose nudging (the particle is moved to
  the ICP-corrected pose),
- ray-cast + ICP (:func:`update_raycast_icp`): each particle's expected
  scan is ray-cast from the map, and the real scan is aligned onto it by
  the same point ICP, with the same goodness weights and nudge.

Resampling is systematic, triggered below Neff < 0.5·P. Global
relocalization scores a large uniform pose batch in one shot.

Random numbers come from an explicit ``torch.Generator`` on the cloud's
device, never from the global state. Every sampling function is split
into its draw and a deterministic part that takes the draws
(``init_from_noise``, ``predict_with_noise``, ``systematic_resample_at``,
``maybe_resample_at``, ``global_relocalize_poses``, ``kld_resample_at``),
so that the same draws give the same cloud whatever made them.

Where a rank decides (``estimate``, ``dispersion``, the kept samples of
``global_relocalize``), equal scores are the rule: log-weights are equal
right after a resample, and every sample outside free space scores 0.
Among equals the lower index wins (a stable descending sort).

The tick's four phases (``predict_with_noise``, ``update_field``,
``maybe_resample_at``, ``estimate``) each issue tens of small kernels.
On CUDA tensors each phase replays a captured CUDA graph of its device
work from its second call with the same shapes and scalars on
(``GRAPHS``, ``utils/cuda_graphs``): the same kernels, bit for bit, for
the host cost of the copies in, one replay and the clones out. Every
other call, on the CPU among them, runs the phase's code eagerly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..core import se2
from ..core.scan import LaserModel, Scan
from ..mapping.occupancy import OccupancyGrid
from ..ops import icp_points
from ..ops.icp_points import PointIcpResult, match_icp_points, scan_to_points
from ..utils.cuda_graphs import GraphCache
from ..utils.profiling import profiler, trace
from .raycast import (
    SIMULATE_BYTES_PER_SAMPLE,
    beam_likelihood,
    endpoint_likelihood,
    simulate_scan,
)

Tensor = torch.Tensor

# Noise / Neff constants.
PREDICT_SIGMA_XY = 0.25       # [m]
PREDICT_SIGMA_THETA = 0.15    # [rad]
NEFF_RESAMPLE_FRACTION = 0.5
TOP_K = 8                     # top-K weighted mean

GRAPHS = GraphCache("pf")
"""The captured graphs of the tick's phases, keyed by each phase's body
and what it binds; counters ``pf.graph_captures`` and
``pf.graph_replays``. A test that monkeypatches a callee of a phase on
CUDA tensors clears it."""

# Device memory one chunk of particles may hold in ``update_beam``,
# ``update_icp`` and ``update_raycast_icp``, whose intermediates grow with
# particles × beams × (range samples | map points | simulated points).
CHUNK_BYTES = 2 << 30
# The ICP of the particle filter's ICP models: fixed iterations from a
# 0.6 m correspondence gate.
PF_ICP_ITERS = 10
PF_ICP_MAX_CORR = 0.6


class ParticleState(NamedTuple):
    poses: Tensor    # [P, 3]
    log_w: Tensor    # [P] log weights (normalized)

    @property
    def n(self) -> int:
        return self.poses.shape[0]


def _normalize(log_w: Tensor) -> Tensor:
    return log_w - torch.logsumexp(log_w, dim=0)


def _top(log_w: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The ``k`` largest values and their indices, the lower index first
    among equals."""
    vals, idx = torch.sort(log_w, descending=True, stable=True)
    return vals[:k], idx[:k]


def _chunk(n_particles: int, bytes_per_particle: int, chunk: int | None) -> int:
    if chunk is not None:
        return max(int(chunk), 1)
    return max(min(n_particles, CHUNK_BYTES // max(bytes_per_particle, 1)), 1)


def _jitter(poses: Tensor, noise_xy: Tensor, noise_t: Tensor,
            sigma_xy: float, sigma_theta: float) -> Tensor:
    return torch.stack(
        [
            poses[..., 0] + noise_xy[:, 0] * sigma_xy,
            poses[..., 1] + noise_xy[:, 1] * sigma_xy,
            se2.normalize_angle(poses[..., 2] + noise_t * sigma_theta),
        ],
        dim=-1,
    )


def _normal_draws(generator: torch.Generator, n: int) -> tuple[Tensor, Tensor]:
    dev = generator.device
    return (torch.randn(n, 2, generator=generator, device=dev),
            torch.randn(n, generator=generator, device=dev))


def init_from_noise(
    pose: Tensor, noise_xy: Tensor, noise_t: Tensor,
    sigma_xy: float = PREDICT_SIGMA_XY,
    sigma_theta: float = PREDICT_SIGMA_THETA,
) -> ParticleState:
    """Cloud around ``pose [3]`` from standard-normal draws ``noise_xy
    [P, 2]`` and ``noise_t [P]``."""
    poses = _jitter(pose, noise_xy, noise_t, sigma_xy, sigma_theta)
    return ParticleState(poses=poses, log_w=_normalize(torch.zeros_like(noise_t)))


def init_gaussian(
    generator: torch.Generator, pose: Tensor, n: int,
    sigma_xy: float = PREDICT_SIGMA_XY,
    sigma_theta: float = PREDICT_SIGMA_THETA,
) -> ParticleState:
    """Cloud of ``n`` particles around a known pose, on the generator's
    device."""
    noise_xy, noise_t = _normal_draws(generator, n)
    return init_from_noise(pose.to(noise_t.device), noise_xy, noise_t, sigma_xy, sigma_theta)


def predict_with_noise(
    state: ParticleState, rel: Tensor, noise_xy: Tensor, noise_t: Tensor,
    sigma_xy: float = PREDICT_SIGMA_XY,
    sigma_theta: float = PREDICT_SIGMA_THETA,
) -> ParticleState:
    """Propagate every particle by the odometry increment ``rel [3]``
    plus the given standard-normal draws, scaled."""
    with trace("pf.predict"):
        poses = GRAPHS(functools.partial(_predicted, sigma_xy=sigma_xy, sigma_theta=sigma_theta),
                       state.poses, rel, noise_xy, noise_t)
        return ParticleState(poses=poses, log_w=state.log_w)


def _predicted(poses: Tensor, rel: Tensor, noise_xy: Tensor, noise_t: Tensor,
               sigma_xy: float, sigma_theta: float) -> Tensor:
    return _jitter(se2.compose(poses, rel[None, :]), noise_xy, noise_t, sigma_xy, sigma_theta)


def predict(
    state: ParticleState, rel: Tensor, generator: torch.Generator,
    sigma_xy: float = PREDICT_SIGMA_XY,
    sigma_theta: float = PREDICT_SIGMA_THETA,
) -> ParticleState:
    """Propagate every particle by the odometry increment ``rel`` plus
    Gaussian noise (a standard SIR propagate: per particle, which keeps
    multimodality)."""
    noise_xy, noise_t = _normal_draws(generator, state.n)
    return predict_with_noise(state, rel, noise_xy, noise_t, sigma_xy, sigma_theta)


def _reweighted(log_w: Tensor, lik: Tensor) -> Tensor:
    return _normalize(log_w + torch.log(lik + 1e-12))


def _reweight(state: ParticleState, lik: Tensor, poses: Tensor | None = None) -> ParticleState:
    return ParticleState(poses=state.poses if poses is None else poses,
                         log_w=_reweighted(state.log_w, lik))


def update_field(
    state: ParticleState,
    field: Tensor,
    grid: OccupancyGrid,
    model: LaserModel,
    ranges: Tensor,
    valid: Tensor,
) -> ParticleState:
    """Likelihood-field weight update (one batched gather of ``[P, N]``).
    The field is read where it lies: its graph is keyed by its address."""
    with trace("pf.update"):
        log_w = GRAPHS(functools.partial(_field_weights, field, grid.spec, model),
                       state.poses, state.log_w, ranges, valid)
        return ParticleState(poses=state.poses, log_w=log_w)


def _field_weights(field: Tensor, spec, model: LaserModel, poses: Tensor, log_w: Tensor,
                   ranges: Tensor, valid: Tensor) -> Tensor:
    return _reweighted(log_w, endpoint_likelihood(field, spec, model, poses, ranges, valid))


def update_beam(
    state: ParticleState,
    grid: OccupancyGrid,
    model: LaserModel,
    ranges: Tensor,
    valid: Tensor,
    sigma: float = 0.5,
    chunk: int | None = None,
) -> ParticleState:
    """Ray-cast beam-model update. The cloud goes through the ray march
    in chunks of particles: ``chunk`` particles if given; else, on CUDA,
    where the kernel holds a few floats a ray, the whole cloud; on the
    CPU, as many as fit ``CHUNK_BYTES`` in the dense ladder's ``[P, N,
    S]`` samples (``S = max_range / resolution``). The likelihoods are
    summed over the beams in the ladder's chunks on either path
    (``beam_likelihood``'s ``rows``), so the weights equal the ladder's
    bit for bit: on the card a float32 row sum rounds by the shape it is
    taken in.

    Spans: ``pf.update`` around the whole update, ``pf.raycast`` around
    the chunk loop (the march and the beam likelihood). Counters, host
    integers: ``pf.raycast_rays`` adds ``P · N``, ``pf.raycast_chunks``
    the chunks the cloud took."""
    with trace("pf.update"):
        n_samples = int(model.max_range / grid.spec.resolution)
        rows = _chunk(state.n, model.n_beams * n_samples * SIMULATE_BYTES_PER_SAMPLE, chunk)
        step = state.n if state.poses.is_cuda and chunk is None else rows
        profiler.count("pf.raycast_rays", state.n * model.n_beams)
        profiler.count("pf.raycast_chunks", -(-state.n // step))
        with trace("pf.raycast"):
            lik = torch.cat([
                beam_likelihood(grid, model, state.poses[i:i + step], ranges, valid, sigma=sigma,
                                rows=rows)
                for i in range(0, state.n, step)
            ])
        return _reweight(state, lik)


def update_icp(
    state: ParticleState,
    map_pts: Tensor,
    map_valid: Tensor,
    model: LaserModel,
    scan_pts: Tensor,
    scan_valid: Tensor,
    nudge: bool = True,
    chunk: int | None = None,
) -> ParticleState:
    """ICP-refined update: match the scan ``[N, 2]`` from each particle
    pose against the map cloud ``[M, 2]``; weight by goodness and
    (optionally) move the particle to the corrected pose. The
    nearest-neighbour search holds ``[P, N, M]``, so the cloud goes
    through it in chunks of particles, as in :func:`update_beam`."""
    n, m = scan_pts.shape[0], map_pts.shape[0]
    step = _chunk(state.n, n * m * icp_points.BYTES_PER_PAIR, chunk)
    res = []
    for i in range(0, state.n, step):
        p = state.poses[i:i + step]
        b = p.shape[0]
        res.append(match_icp_points(
            map_pts.expand(b, m, 2), map_valid.expand(b, m),
            scan_pts.expand(b, n, 2), scan_valid.expand(b, n), p,
            iters=PF_ICP_ITERS, max_corr=PF_ICP_MAX_CORR,
        ))
    return _icp_reweight(state, res, nudge)


def _icp_reweight(state: ParticleState, res: list[PointIcpResult], nudge: bool) -> ParticleState:
    """The ICP models' weights and nudge from the chunks' matches ``res``
    in the cloud's order: the likelihood is the goodness, ``1e-6`` where
    the match failed; with ``nudge`` a particle whose match held moves to
    its corrected pose."""
    fail = torch.cat([r.fail for r in res])
    lik = torch.where(fail, 1e-6, torch.cat([r.goodness for r in res]))
    moved = torch.cat([r.pose for r in res])
    poses = state.poses if not nudge else torch.where(fail[:, None], state.poses, moved)
    return _reweight(state, lik, poses)


def update_raycast_icp(
    state: ParticleState,
    grid: OccupancyGrid,
    model: LaserModel,
    ranges: Tensor,
    valid: Tensor,
    nudge: bool = True,
    chunk: int | None = None,
) -> ParticleState:
    """Ray-cast + ICP update: each particle's expected scan is simulated
    from the map (:func:`simulate_scan`), its hits below ``max_range``
    become world points, and the observed scan ``[N]`` is aligned onto
    them by :func:`match_icp_points` from the particle's pose (10
    iterations from a 0.6 m gate, as :func:`update_icp`). The weight is
    the match's goodness, ``1e-6`` where it failed; with ``nudge`` the
    particle moves to the corrected pose. The observed points are the
    beams that ``valid`` keeps and that lie inside the sensor's range
    (:func:`scan_to_points`).

    The march takes the whole cloud in one launch on CUDA tensors and, on
    the CPU, chunks of particles whose ``[P, N, S]`` ladder fits
    ``CHUNK_BYTES``. The ICP goes through the cloud in ``chunk`` particles
    if given, else in the fewest chunks of equal size whose intermediates
    fit ``CHUNK_BYTES`` (``icp_points.bytes_per_row``): on CUDA float32
    tensors the kernel searches and an iteration holds ``[P, N]`` tensors
    (one chunk at 4096 particles and 361 beams), elsewhere the plain
    search holds ``[P, N, N]``.

    Spans: ``pf.update`` around the whole update, ``pf.raycast`` around
    the march, ``pf.icp`` around the chunk loop of the search (where the
    ``h1_nearest_two`` ranges lie). Counters, host integers:
    ``pf.raycast_rays`` adds ``P · N`` and ``pf.raycast_chunks`` the
    march's chunks, as in :func:`update_beam`; ``pf.icp_pairs`` adds
    ``P · N · N · iterations``, ``pf.icp_chunks`` the search's chunks."""
    with trace("pf.update"):
        n, p = model.n_beams, state.n
        n_samples = int(model.max_range / grid.spec.resolution)
        march = p if state.poses.is_cuda else _chunk(
            p, n * n_samples * SIMULATE_BYTES_PER_SAMPLE, None)
        profiler.count("pf.raycast_rays", p * n)
        profiler.count("pf.raycast_chunks", -(-p // march))
        profiler.count("pf.icp_pairs", p * n * n * PF_ICP_ITERS)
        with trace("pf.raycast"):
            sim = torch.cat([simulate_scan(grid, model, state.poses[i:i + march])
                             for i in range(0, p, march)])
        fi = model.bearings(ranges.dtype, ranges.device)
        ang = state.poses[:, 2:3] + fi
        sim_pts = torch.stack([state.poses[:, 0:1] + sim * torch.cos(ang),
                               state.poses[:, 1:2] + sim * torch.sin(ang)], dim=-1)
        sim_ok = sim < model.max_range
        scan_pts, scan_ok = scan_to_points(model, Scan(ranges, ~valid, None))
        step = _chunk(p, icp_points.bytes_per_row(scan_pts, sim_pts), chunk)
        if chunk is None:           # the fewest chunks that fit, of equal size
            step = -(-p // -(-p // step))
        profiler.count("pf.icp_chunks", -(-p // step))
        res = []
        with trace("pf.icp"):
            for i in range(0, p, step):
                b = min(step, p - i)
                res.append(match_icp_points(
                    sim_pts[i:i + b], sim_ok[i:i + b], scan_pts.expand(b, n, 2),
                    scan_ok.expand(b, n), state.poses[i:i + b],
                    iters=PF_ICP_ITERS, max_corr=PF_ICP_MAX_CORR,
                ))
        return _icp_reweight(state, res, nudge)


def neff(state: ParticleState) -> Tensor:
    w = torch.exp(state.log_w)
    return 1.0 / torch.sum(w * w)


def systematic_resample_at(state: ParticleState, u: Tensor | float) -> ParticleState:
    """Systematic (low-variance) resampling from one uniform draw ``u``
    in ``[0, 1)``: particle ``i`` of the new cloud is the one whose
    cumulative weight first reaches ``(u + i) / P``."""
    n = state.n
    w = torch.exp(state.log_w)
    cum = torch.cumsum(w, dim=0)
    lanes = torch.arange(n, device=w.device) / n
    idx = torch.searchsorted(cum, u / n + lanes, right=False)
    idx = torch.clamp(idx, 0, n - 1)
    return ParticleState(
        poses=state.poses[idx], log_w=_normalize(torch.zeros_like(state.log_w))
    )


def _uniform_draw(generator: torch.Generator) -> Tensor:
    return torch.rand((), generator=generator, device=generator.device)


def systematic_resample(state: ParticleState, generator: torch.Generator) -> ParticleState:
    """Systematic (low-variance) resampling."""
    return systematic_resample_at(state, _uniform_draw(generator))


def maybe_resample_at(state: ParticleState, u: Tensor | float) -> ParticleState:
    """Resample (from the uniform draw ``u``) when Neff < 0.5·P; a select
    on the device, no host read. A Python number ``u`` is never baked
    into a graph: such a call runs eagerly."""
    with trace("pf.resample"):
        return ParticleState(*GRAPHS(_maybe_resampled, state.poses, state.log_w, u))


def _maybe_resampled(poses: Tensor, log_w: Tensor, u: Tensor | float) -> tuple[Tensor, Tensor]:
    state = ParticleState(poses, log_w)
    do = neff(state) < NEFF_RESAMPLE_FRACTION * state.n
    resampled = systematic_resample_at(state, u)
    return tuple(torch.where(do, a, b) for a, b in zip(resampled, state))


def maybe_resample(state: ParticleState, generator: torch.Generator) -> ParticleState:
    """Resample when Neff < 0.5·P."""
    return maybe_resample_at(state, _uniform_draw(generator))


def estimate(state: ParticleState, top_k: int = TOP_K) -> Tensor:
    """Weighted mean over the top-K particles with circular angle
    averaging."""
    with trace("pf.estimate"):
        return GRAPHS(functools.partial(_estimated, top_k=top_k), state.poses, state.log_w)


def _estimated(poses: Tensor, log_w: Tensor, top_k: int) -> Tensor:
    k = min(top_k, poses.shape[0])
    vals, idx = _top(log_w, k)
    w = torch.exp(vals - torch.logsumexp(vals, dim=0))
    sel = poses[idx]
    x = torch.sum(w * sel[:, 0])
    y = torch.sum(w * sel[:, 1])
    c = torch.sum(w * torch.cos(sel[:, 2]))
    s = torch.sum(w * torch.sin(sel[:, 2]))
    return torch.stack([x, y, torch.atan2(s, c)])


def dispersion(state: ParticleState, top_k: int = TOP_K) -> Tensor:
    """Mean distance of the top-K particles from their weighted mean (the
    convergence confidence gate)."""
    k = min(top_k, state.n)
    _, idx = _top(state.log_w, k)
    sel = state.poses[idx, :2]
    mean = estimate(state, top_k)[:2]
    return torch.mean(torch.sqrt(torch.sum((sel - mean[None, :]) ** 2, dim=-1)))


def global_relocalize_poses(
    poses: Tensor,
    grid: OccupancyGrid,
    field: Tensor,
    model: LaserModel,
    ranges: Tensor,
    valid: Tensor,
    n_keep: int = 1024,
) -> ParticleState:
    """Score the sampled ``poses [S, 3]`` in one shot and keep the best
    ``n_keep`` as the new cloud. A sample whose cell is not known free
    space scores 0."""
    spec = grid.spec
    x, y = poses[:, 0], poses[:, 1]
    ix = torch.floor((x - spec.origin_x) / spec.resolution).to(torch.int64)
    iy = torch.floor((y - spec.origin_y) / spec.resolution).to(torch.int64)
    ix = torch.clamp(ix, 0, spec.width - 1)
    iy = torch.clamp(iy, 0, spec.height - 1)
    free = grid.log_odds[iy, ix] < 0.0

    lik = endpoint_likelihood(field, spec, model, poses, ranges, valid)
    score = torch.where(free, lik, 0.0)
    vals, idx = _top(score, n_keep)
    return ParticleState(
        poses=poses[idx],
        log_w=_normalize(torch.log(vals + 1e-12)),
    )


def global_relocalize(
    generator: torch.Generator,
    grid: OccupancyGrid,
    field: Tensor,
    model: LaserModel,
    ranges: Tensor,
    valid: Tensor,
    n_samples: int = 10_000,
    n_keep: int = 1024,
) -> ParticleState:
    """Global relocalization: a uniform batch of ``n_samples`` poses over
    the grid's extent, scored by :func:`global_relocalize_poses`."""
    spec = grid.spec
    u = torch.rand(3, n_samples, generator=generator, device=generator.device)
    poses = torch.stack(
        [
            spec.origin_x + u[0] * (spec.width * spec.resolution),
            spec.origin_y + u[1] * (spec.height * spec.resolution),
            -torch.pi + u[2] * (2.0 * torch.pi),
        ],
        dim=-1,
    )
    return global_relocalize_poses(poses, grid, field, model, ranges, valid, n_keep)


# --- KLD adaptive sampling ------------------------------------------------
# Fox's bound: with k occupied histogram bins, n >= (k-1)/(2eps) *
# (1 - 2/(9(k-1)) + sqrt(2/(9(k-1))) * z_{1-delta})^3 keeps the KL
# divergence between the sampled and true posterior below eps with
# confidence 1-delta.
#
# The cloud keeps its shape: instead of growing or shrinking tensors the
# adaptive size is an *active-particle count*; excess particles get -inf
# log weight and drop out of estimates, resampling and updates.

KLD_BIN_XY = 0.5          # [m] histogram bin
KLD_BIN_THETA = 0.1745    # [rad] 10 deg
KLD_EPSILON = 0.02
KLD_Z = 2.326             # z_{1-delta} for delta = 0.01
KLD_MIN_PARTICLES = 64


def kld_sample_size(
    state: ParticleState,
    bin_xy: float = KLD_BIN_XY,
    bin_theta: float = KLD_BIN_THETA,
    epsilon: float = KLD_EPSILON,
    z: float = KLD_Z,
) -> Tensor:
    """Fox's KLD bound on the number of particles needed, from the count
    of occupied (x, y, theta) histogram bins of the *live* cloud."""
    live = torch.isfinite(state.log_w)
    bx = torch.floor(state.poses[:, 0] / bin_xy).to(torch.int32)
    by = torch.floor(state.poses[:, 1] / bin_xy).to(torch.int32)
    bt = torch.floor(
        se2.normalize_angle(state.poses[:, 2]) / bin_theta
    ).to(torch.int32)
    # Distinct-bin count via sort. The spatial hash relies on int32
    # wrap-around (collisions only make the bound slightly conservative).
    sentinel = torch.iinfo(torch.int32).max
    key = (bx * 73856093) ^ (by * 19349663) ^ (bt * 83492791)
    key = torch.where(live & (key != sentinel), key, sentinel)
    s = torch.sort(key).values
    new_bin = torch.cat(
        [torch.ones(1, dtype=torch.bool, device=s.device), s[1:] != s[:-1]]
    ) & (s != sentinel)
    k = torch.clamp(torch.sum(new_bin), min=2).to(torch.float32)

    km1 = k - 1.0
    a = 2.0 / (9.0 * km1)
    n = km1 / (2.0 * epsilon) * (1.0 - a + torch.sqrt(a) * z) ** 3
    return torch.clamp(n, KLD_MIN_PARTICLES, state.n).to(torch.int32)


def kld_resample_at(state: ParticleState, u: Tensor | float) -> ParticleState:
    """Systematic resample (from the uniform draw ``u``) sized by the
    KLD bound: the first ``n_kld`` lanes carry the resampled posterior,
    the rest are parked at -inf weight."""
    n_kld = kld_sample_size(state)
    resampled = systematic_resample_at(state, u)
    active = torch.arange(state.n, device=n_kld.device) < n_kld
    log_w = torch.where(active, 0.0, -torch.inf).to(state.log_w.dtype)
    return ParticleState(poses=resampled.poses, log_w=_normalize(log_w))


def kld_resample(state: ParticleState, generator: torch.Generator) -> ParticleState:
    """Systematic resample sized by the KLD bound."""
    return kld_resample_at(state, _uniform_draw(generator))
