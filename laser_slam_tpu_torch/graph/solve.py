"""SE(2) pose-graph optimization: batched robust Gauss-Newton (port of
``graph/solve.py``).

- the graph is fixed-shape tensors: ``poses [V, 3]``, edges
  ``(i [E], j [E], meas [E, 3], info [E, 3, 3], active [E])`` with an
  ``active`` mask for preallocated-but-unused slots;
- residuals and Jacobians of all edges are computed batched; the normal
  system is assembled by scatter-adds into a dense ``[3V, 3V]`` matrix
  and solved by LU. The submap hierarchy keeps V small (~T/10), so the
  dense solve is exact and cheap; past ``DENSE_SOLVER_MAX_V`` vertices
  the matrix-free block-Jacobi CG path takes over;
- robustness: Huber reweighting on sequential edges, Dynamic Covariance
  Scaling on loop edges;
- gauge freedom fixed by anchoring vertex 0.

The LM and CG loops run on the host and read one flag pair per
iteration (one device sync each).

``optimize`` takes an optional ``reduce``: a sum over the ranks of a
process group (``parallel.distributed.distributed_optimize``). Each rank
then holds a slice of the edges; the edges' normal equations, χ² and,
on the CG route, each operator product are summed by ``reduce`` before
anything else is added (the gauge anchor, the identity blocks of
inactive vertices, the damping), so every rank solves the same system.
Without it nothing is reduced. Everything is float32; the 3×3 block
products are ``einsum``s of elementwise size that never reach a TF32
matmul, and the dense solve is ``torch.linalg.solve``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import se2
from ..utils.profiling import trace

Tensor = torch.Tensor

MAX_GN_ITERS = 20          # outer iteration budget
CHI2_REL_TOL = 1e-5        # Δchi² stop
# Robust kernel width on the Mahalanobis norm. Verified loops carry
# large (drift-sized) residuals that must still pull the graph closed,
# so the kernel only guards against gross outliers.
HUBER_DELTA = 5.0
DCS_PHI = 5.0              # DCS kernel scale for loop edges
# Gauge anchor and damping are chosen for a float32 factorization: the
# anchor must dominate typical information (~50) without exploding the
# condition number, and damping floors the gauge-null eigenvalues.
ANCHOR_WEIGHT = 1e4
DAMPING = 1e-2

KERNEL_HUBER = 0
KERNEL_DCS = 1

# Above this vertex count the dense [3V, 3V] factor (O(V²) memory,
# O(V³) time) loses to matrix-free CG.
DENSE_SOLVER_MAX_V = 1024


class PoseGraph(NamedTuple):
    """Fixed-capacity SE(2) pose graph (all leaves tensors of one device)."""

    poses: Tensor     # [V, 3]
    v_active: Tensor  # [V] bool
    i: Tensor         # [E] int64 source vertex
    j: Tensor         # [E] int64 target vertex
    meas: Tensor      # [E, 3] measured relative pose (i → j)
    info: Tensor      # [E, 3, 3] information matrices
    e_active: Tensor  # [E] bool
    kernel: Tensor | None = None  # [E] int: 0 = Huber, 1 = DCS (loops)


def edge_residuals(g: PoseGraph) -> Tensor:
    """``[E, 3]`` residuals ``log(meas⁻¹ ⊕ (xi⁻¹ ⊕ xj))``."""
    pred = se2.relative(g.poses[g.i], g.poses[g.j])
    d = se2.relative(g.meas, pred)
    return torch.cat([d[:, :2], se2.normalize_angle(d[:, 2:3])], dim=-1)


def edge_jacobians(g: PoseGraph) -> tuple[Tensor, Tensor]:
    """Analytic Jacobians ``(Ji [E,3,3], Jj [E,3,3])`` of the residual wrt
    perturbations of ``xi`` and ``xj`` (additive on ``(x, y, θ)``)."""
    xi = g.poses[g.i]
    xj = g.poses[g.j]
    thi = xi[:, 2]
    dz = xj[:, :2] - xi[:, :2]
    c, s = torch.cos(thi), torch.sin(thi)
    zc, zs = torch.cos(g.meas[:, 2]), torch.sin(g.meas[:, 2])

    # Rotation matrices R(θi)ᵀ and R(zθ)ᵀ.
    rit = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], dim=-2)
    rzt = torch.stack([torch.stack([zc, zs], -1), torch.stack([-zs, zc], -1)], dim=-2)
    rzt_rit = torch.einsum("eij,ejk->eik", rzt, rit)       # [E, 2, 2]

    # d(R(θi)ᵀ dz)/dθi = R'(θi)ᵀ dz ; R'(θ)ᵀ = [[-s, c], [-c, -s]]
    dri = torch.stack(
        [-s * dz[:, 0] + c * dz[:, 1], -c * dz[:, 0] - s * dz[:, 1]], dim=-1
    )
    dth_i = torch.einsum("eij,ej->ei", rzt, dri)           # [E, 2]

    zero = torch.zeros_like(thi)
    one = torch.ones_like(thi)
    ji_top = torch.cat([-rzt_rit, dth_i[..., None]], dim=-1)          # [E, 2, 3]
    ji_bot = torch.stack([zero, zero, -one], dim=-1)[:, None, :]      # [E, 1, 3]
    Ji = torch.cat([ji_top, ji_bot], dim=-2)
    jj_top = torch.cat([rzt_rit, torch.zeros_like(dth_i)[..., None]], dim=-1)
    jj_bot = torch.stack([zero, zero, one], dim=-1)[:, None, :]
    Jj = torch.cat([jj_top, jj_bot], dim=-2)
    return Ji, Jj


def _edge_terms(g: PoseGraph):
    """Per-edge robustly weighted normal-equation blocks
    ``(Hii, Hjj, Hij, bi, bj, chi2)`` with shapes ``[E,3,3]×3, [E,3]×2,
    [E]``."""
    r = edge_residuals(g)
    # Inactive slots may hold NaN measurements; zero them before any
    # arithmetic (0·NaN = NaN).
    r = torch.where(g.e_active[:, None], torch.nan_to_num(r), 0.0)
    Ji, Jj = edge_jacobians(g)
    Ji = torch.nan_to_num(Ji)
    Jj = torch.nan_to_num(Jj)

    chi = torch.einsum("ei,eij,ej->e", r, g.info, r)
    # Huber: w = 1 for small chi, δ/√chi beyond.
    sqrt_chi = torch.sqrt(torch.clamp(chi, min=1e-12))
    w_huber = torch.where(sqrt_chi > HUBER_DELTA, HUBER_DELTA / sqrt_chi, 1.0)
    # Dynamic Covariance Scaling: s = min(1, 2Φ/(Φ+χ²)), weight s².
    s = torch.clamp(2.0 * DCS_PHI / (DCS_PHI + chi), max=1.0)
    w_dcs = s * s
    w = w_huber if g.kernel is None else torch.where(g.kernel == KERNEL_DCS, w_dcs, w_huber)
    w = torch.where(g.e_active, w, 0.0)

    wi = w[:, None, None] * g.info
    Hii = torch.einsum("eki,ekl,elj->eij", Ji, wi, Ji)
    Hjj = torch.einsum("eki,ekl,elj->eij", Jj, wi, Jj)
    Hij = torch.einsum("eki,ekl,elj->eij", Ji, wi, Jj)
    bi = torch.einsum("eki,ekl,el->ei", Ji, wi, r)
    bj = torch.einsum("eki,ekl,el->ei", Jj, wi, r)
    return Hii, Hjj, Hij, bi, bj, w * chi


def _scatter_blocks(rows: Tensor, cols: Tensor, blocks: Tensor, out: Tensor) -> Tensor:
    """``out[rows[e], cols[e]] += blocks[e]`` on an ``[V, V, n, n]`` tensor."""
    return out.index_put_((rows, cols), blocks, accumulate=True)


def _reduced(reduce, *parts: Tensor) -> tuple[Tensor, ...]:
    """``parts`` summed over the ranks in one call of ``reduce`` (which may
    work in place on the flat buffer it is given); unchanged without one."""
    if reduce is None:
        return parts
    flat = reduce(torch.cat([p.reshape(-1) for p in parts]))
    return tuple(x.view(p.shape) for x, p in zip(torch.split(flat, [p.numel() for p in parts]), parts))


def assemble_normal_system(g: PoseGraph, reduce=None) -> tuple[Tensor, Tensor, Tensor]:
    """Dense ``[3V, 3V]`` H, ``[3V]`` b via scatter-adds, plus chi²
    (each summed by ``reduce``, when given)."""
    v = g.poses.shape[0]
    Hii, Hjj, Hij, bi, bj, chi = _edge_terms(g)
    H = torch.zeros(v, v, 3, 3, dtype=g.poses.dtype, device=g.poses.device)
    _scatter_blocks(g.i, g.i, Hii, H)
    _scatter_blocks(g.j, g.j, Hjj, H)
    _scatter_blocks(g.i, g.j, Hij, H)
    _scatter_blocks(g.j, g.i, Hij.transpose(-1, -2), H)
    b = torch.zeros(v, 3, dtype=g.poses.dtype, device=g.poses.device)
    b.index_add_(0, g.i, bi)
    b.index_add_(0, g.j, bj)
    Hd = H.permute(0, 2, 1, 3).reshape(3 * v, 3 * v)
    return _reduced(reduce, Hd, b.reshape(3 * v), torch.sum(chi))


def _solve_normal(g: PoseGraph, lam, reduce=None) -> tuple[Tensor, Tensor]:
    """Solve the λ-damped normal equations; returns ``(dx [V,3], chi²)``."""
    Hd, b, chi2_w = assemble_normal_system(g, reduce)
    return _chol_solve_damped(g, Hd, b, lam), chi2_w


def _chol_solve_damped(g: PoseGraph, Hd: Tensor, b: Tensor, lam) -> Tensor:
    v = g.poses.shape[0]
    dtype, dev = Hd.dtype, Hd.device
    # Gauge fix: anchor vertex 0 with a strong prior instead of deleting
    # rows (shapes stay static).
    anchor = torch.zeros(3 * v, dtype=dtype, device=dev)
    anchor[:3] = ANCHOR_WEIGHT
    # Inactive vertices get identity blocks so the solve stays full-rank.
    diag_fix = (~g.v_active).repeat_interleave(3).to(dtype) + anchor
    # Marquardt scaling: λ multiplies the diagonal. The absolute floor
    # scales with the largest diagonal entry: float32 assembly round-off
    # perturbs the eigenvalues of the (PSD by construction) H by
    # O(ε·‖H‖), and a fixed floor below that leaves the damped matrix
    # indefinite on large graphs.
    diag_h = torch.clamp(torch.diagonal(Hd), min=1.0)
    floor = DAMPING + 1e-4 * torch.max(diag_h)
    Hd = Hd + torch.diag(diag_fix + lam * diag_h + floor)
    # LU, not Cholesky: a gauge-anchored normal matrix reaches condition
    # numbers of 1e6 and more, where a float32 Cholesky fails.
    with trace("h4_solve"):
        dx, _ = torch.linalg.solve_ex(Hd, -b[:, None])
    return dx.reshape(v, 3)


def _cg_solve_normal(
    g: PoseGraph, lam, cg_iters: int = 100, tol: float = 1e-6, reduce=None
) -> tuple[Tensor, Tensor]:
    """Matrix-free block-Jacobi-preconditioned CG on the damped normal
    equations — the large-V path. Never materializes H: the operator is
    two scatter products over edge blocks, O(E·9) per iteration and
    O(V+E) memory. Returns ``(dx [V,3], chi²)``."""
    v = g.poses.shape[0]
    dtype, dev = g.poses.dtype, g.poses.device
    Hii, Hjj, Hij, bi, bj, chi = _edge_terms(g)

    def scatter(shape, a, b_):
        return torch.zeros(shape, dtype=dtype, device=dev).index_add_(0, g.i, a).index_add_(0, g.j, b_)

    b, diag_blocks, chi2_w = _reduced(
        reduce, scatter((v, 3), bi, bj), scatter((v, 3, 3), Hii, Hjj), torch.sum(chi))
    # Diagonal terms: gauge anchor, inactive-vertex identity, damping.
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    anchor = torch.zeros(v, dtype=dtype, device=dev)
    anchor[0] = ANCHOR_WEIGHT
    inactive = (~g.v_active).to(dtype)
    diag_h = torch.clamp(torch.diagonal(diag_blocks, dim1=-2, dim2=-1), min=1.0)   # [V, 3]
    floor = DAMPING + 1e-4 * torch.max(diag_h)
    extra = (
        (anchor + inactive)[:, None, None] * eye3
        + lam * diag_h[..., None] * eye3
        + floor * eye3
    )
    diag_all = diag_blocks + extra

    def hvp(x: Tensor) -> Tensor:                           # [V,3] → [V,3]
        yi = torch.einsum("eij,ej->ei", Hij, x[g.j])
        yj = torch.einsum("eji,ej->ei", Hij, x[g.i])        # Hijᵀ x_i
        (off,) = _reduced(reduce, scatter((v, 3), yi, yj))
        return off + torch.einsum("vij,vj->vi", diag_all, x)

    # Block-Jacobi preconditioner: per-vertex 3×3 inverse.
    minv = torch.linalg.inv_ex(diag_all)[0]

    def precond(r):
        return torch.einsum("vij,vj->vi", minv, r)

    rhs = -b
    x = torch.zeros(v, 3, dtype=dtype, device=dev)
    r = rhs - hvp(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    b2 = torch.clamp(torch.sum(rhs * rhs), min=1e-30)
    for _ in range(cg_iters):
        if not bool(torch.sum(r * r) > tol * tol * b2):    # one sync an iteration
            break
        hp = hvp(p)
        alpha = rz / torch.clamp(torch.sum(p * hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = z + beta * p
        rz = rz_new
    return x, chi2_w


def _apply(g: PoseGraph, dx: Tensor) -> Tensor:
    new_poses = torch.cat(
        [g.poses[:, :2] + dx[:, :2], se2.normalize_angle(g.poses[:, 2:3] + dx[:, 2:3])],
        dim=-1,
    )
    return torch.where(g.v_active[:, None], new_poses, g.poses)


def weighted_chi2(g: PoseGraph, reduce=None) -> Tensor:
    """Robustly weighted chi² (the LM acceptance objective), summed by
    ``reduce`` when given."""
    return _reduced(reduce, _edge_terms(g)[-1].sum())[0]


def gn_step(g: PoseGraph) -> tuple[PoseGraph, Tensor]:
    """One undamped Gauss-Newton step (for tests and small graphs)."""
    dx, chi = _solve_normal(g, 0.0)
    return g._replace(poses=_apply(g, dx)), chi


def optimize(
    g: PoseGraph,
    max_iters: int = MAX_GN_ITERS,
    solver: str = "auto",
    info: dict | None = None,
    reduce=None,
) -> tuple[PoseGraph, Tensor]:
    """Levenberg-Marquardt with accept/reject and adaptive λ; returns
    ``(graph, final weighted chi²)``.

    Plain GN oscillates on loop closures with large rotational residuals
    (drift-sized corrections); LM's step control is what tames them.
    ``solver``: ``"chol"`` (dense LU), ``"cg"`` (matrix-free block-Jacobi
    CG for large V), or ``"auto"``.

    The loop runs on the host: λ, the iteration and stall counters live
    there (λ in float32), and each iteration reads two flags from the
    device in one transfer. With a dict ``info``, the counts are left in
    it: ``iters`` (iterations run) and ``steps`` (steps accepted).
    With ``reduce`` (a sum over the ranks of a process group) each rank
    holds a slice of the edges and every rank takes the same steps: the
    accept and stop flags come from the reduced χ².
    """
    if solver == "auto":
        solver = "cg" if g.poses.shape[0] > DENSE_SOLVER_MAX_V else "chol"
    solve = _cg_solve_normal if solver == "cg" else _solve_normal

    chi_cur = weighted_chi2(g, reduce)
    lam = np.float32(1e-4)
    it = stall = steps = 0
    while it < max_iters and stall < 3:
        dx, _ = solve(g, float(lam), reduce=reduce)
        cand = g._replace(poses=_apply(g, dx))
        chi_cand = weighted_chi2(cand, reduce)
        # A failed solve yields NaN poses whose residuals are zeroed by
        # nan_to_num, chi² == 0, a perfect score: a candidate must be
        # finite to be accepted.
        accept_t = (chi_cand < chi_cur) & torch.all(torch.isfinite(cand.poses))
        chi_next = torch.where(accept_t, chi_cand, chi_cur)
        improved_t = chi_cur - chi_next > CHI2_REL_TOL
        accept, improved = torch.stack([accept_t, improved_t]).tolist()
        if accept:
            g = cand
            steps += 1
            lam = max(lam * np.float32(0.3), np.float32(1e-6))
        else:
            lam = lam * np.float32(5.0)
        chi_cur = chi_next
        stall = 0 if improved else stall + 1
        it += 1
    if info is not None:
        info.update(iters=it, steps=steps)
    return g, chi_cur


def chi2(g: PoseGraph) -> Tensor:
    """Raw chi² of the active edges (no robust kernel)."""
    r = edge_residuals(g)
    r = torch.where(g.e_active[:, None], torch.nan_to_num(r), 0.0)
    c = torch.einsum("ei,eij,ej->e", r, g.info, r)
    return torch.sum(torch.where(g.e_active, c, 0.0))


# ---------------------------------------------------------------------------
# Linear initialization (LAGO-style). 2D pose graphs are special: given
# relative-angle measurements the orientations are a *linear* problem in
# unit-circle embeddings, and given orientations the positions are linear
# too. Two small dense solves produce a near-global initialization that
# GN/LM cannot reach from drifted odometry (large coordinated rotations
# are the classic pose-graph local minimum).
# ---------------------------------------------------------------------------


def _masked_w(g: PoseGraph, idx: int) -> Tensor:
    return torch.where(g.e_active, g.info[:, idx, idx], 0.0)


def linear_initialize(g: PoseGraph) -> PoseGraph:
    """Rotation-then-translation linear initialization.

    Stage 1: embed each orientation as a point ``z_i`` on the plane and
    minimize ``Σ w‖z_j − R(δθ_e) z_i‖²`` (anchored ``z_0 = (1,0)``), a
    linear system whose solution's ``atan2`` is a near-optimal set of
    absolute orientations regardless of 2π wraps; one IRLS (Cauchy)
    reweighting pass cuts the influence of aliased false loops.

    Stage 2: with orientations fixed, minimize
    ``Σ w‖t_j − t_i − R(θ_i) δt_e‖²``, linear in the positions.
    """
    v = g.poses.shape[0]
    dtype, dev = g.poses.dtype, g.poses.device
    meas = torch.where(g.e_active[:, None], torch.nan_to_num(g.meas), 0.0)
    eye2 = torch.eye(2, dtype=dtype, device=dev)

    def laplacian_solve(rot_edges: Tensor, rhs_edges: Tensor, w: Tensor, anchor_val: Tensor):
        """Solve Σ w‖x_j − A_e x_i − c_e‖² for x ∈ R^{V×2}, x_0 anchored.
        ``rot_edges [E,2,2]``: A_e; ``rhs_edges [E,2]``: c_e."""
        H = torch.zeros(v, v, 2, 2, dtype=dtype, device=dev)
        w3 = w[:, None, None]
        AtA = torch.einsum("eki,ekj->eij", rot_edges, rot_edges) * w3
        _scatter_blocks(g.i, g.i, AtA, H)
        _scatter_blocks(g.j, g.j, w3 * eye2, H)
        cross = -rot_edges * w3                            # (J_jᵀ W J_i) = -A w
        _scatter_blocks(g.j, g.i, cross, H)
        _scatter_blocks(g.i, g.j, cross.transpose(-1, -2), H)

        # residual r = x_j - A x_i - c ; ∂r/∂x_i = -A, ∂r/∂x_j = I
        b = torch.zeros(v, 2, dtype=dtype, device=dev)
        b.index_add_(0, g.i, torch.einsum("eki,ek->ei", rot_edges, rhs_edges) * w[:, None])
        b.index_add_(0, g.j, -rhs_edges * w[:, None])

        # Anchor and ridge sized for float32: the gauge prior only has to
        # dominate typical edge information (~50), the ridge only to floor
        # the near-null chain modes.
        lin_anchor = 1e3
        diag = torch.full((2 * v,), 1e-3, dtype=dtype, device=dev)
        diag[:2] += lin_anchor
        Hd = H.permute(0, 2, 1, 3).reshape(2 * v, 2 * v) + torch.diag(diag)
        rhs = -b
        rhs[0] = rhs[0] + anchor_val * lin_anchor
        with trace("h4_solve"):
            x, _ = torch.linalg.solve_ex(Hd, rhs.reshape(-1, 1))
        return x.reshape(v, 2)

    dth = meas[:, 2]
    rot = se2.rotation_matrix(dth)                         # [E, 2, 2]
    w_th = _masked_w(g, 2)
    zero_rhs = torch.zeros(meas.shape[0], 2, dtype=dtype, device=dev)
    e1 = torch.tensor([1.0, 0.0], dtype=dtype, device=dev)

    def unit(z):
        n = torch.sqrt(torch.sum(z * z, dim=-1, keepdim=True))
        return z / torch.clamp(n, min=1e-6)

    def theta_residual(z):
        pred = torch.einsum("eij,ej->ei", rot, unit(z[g.i]))
        d = unit(z[g.j]) - pred
        return torch.sqrt(torch.sum(d * d, dim=-1))        # chord distance

    z = laplacian_solve(rot, zero_rhs, w_th, e1)
    r1 = theta_residual(z)
    w_irls = 1.0 / (1.0 + (r1 / 0.5) ** 2)                 # ~30° chord scale
    z = laplacian_solve(rot, zero_rhs, w_th * w_irls, e1)
    theta = torch.atan2(z[:, 1], z[:, 0])

    # Stage 2: positions, orientations fixed; reuse the robustness weights
    # (an edge with a wrong rotation has a wrong translation).
    ci, si = torch.cos(theta[g.i]), torch.sin(theta[g.i])
    rhs = torch.stack(
        [ci * meas[:, 0] - si * meas[:, 1], si * meas[:, 0] + ci * meas[:, 1]], dim=-1
    )                                                      # R(θ_i) δt
    eyeE = eye2[None].expand(meas.shape[0], 2, 2)
    w_t = 0.5 * (_masked_w(g, 0) + _masked_w(g, 1)) * w_irls
    t = laplacian_solve(eyeE, rhs, w_t, g.poses[0, :2])

    new_poses = torch.cat([t, theta[:, None]], dim=-1)
    return g._replace(poses=torch.where(g.v_active[:, None], new_poses, g.poses))


def optimize_with_init(
    g: PoseGraph, max_iters: int = MAX_GN_ITERS, info: dict | None = None
) -> tuple[PoseGraph, Tensor]:
    """Linear initialization followed by LM polish, from whichever start
    scores better on the RAW chi²: DCS scores a start that leaves loop
    residuals huge as *good* (it annihilates exactly the unexplained
    edges), so a weighted comparison would reject every loop-closing
    initialization in favor of drifted odometry. A failed (non-finite)
    linear solve never wins. ``info`` as for :func:`optimize`."""
    g_lin = linear_initialize(g)
    better = (chi2(g_lin) < chi2(g)) & torch.all(torch.isfinite(g_lin.poses))
    return optimize(g._replace(poses=torch.where(better, g_lin.poses, g.poses)), max_iters,
                    info=info)
