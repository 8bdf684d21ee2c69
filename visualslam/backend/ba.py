"""Sliding-window bundle adjustment: damped Gauss-Newton with landmark
(Schur) elimination.

Absent in the reference (BASELINE.json configs[3]; SURVEY.md §2.3) — designed
as fixed-shape array code:

  - observations are a fixed-capacity SoA (cam_idx, lm_idx, uv, valid), the
    sparse structure is handled with segment_sum scatter-adds, never
    data-dependent loops;
  - the camera-landmark coupling W is materialized DENSE [C,6,L,3]
    (C<=10, L<=8k -> ~6 MB) so the Schur product S = U - W V^-1 W^T is one
    big matmul instead of sparse gather-scatter;
  - 3x3 landmark blocks invert in closed form (batched adjugate);
  - the reduced 6C x 6C camera system solves dense (C is small);
  - Levenberg-Marquardt runs a FIXED number of iterations with masked
    accept/reject (no early exit), carrying (poses, points, lambda) through
    lax.fori_loop-style Python unroll (iters is static config).

Conventions: world-to-camera poses (x_cam = R X + t), residuals on the
normalized image plane, left-multiplicative se(3) perturbation
exp(xi) . T with xi = [omega, v]. Jacobians are analytic:
  d x_cam / d xi = [ -[x_cam]_x | I ],   d x_cam / d X = R
  d pi / d p = [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]],  pi(p) = p_xy / p_z.

Distribution (parallel/dist_ba.py): shard landmarks+observations, psum the
reduced system, solve replicated, update landmarks shard-local.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from visualslam.geometry import se3
from visualslam.utils.config import BAConfig


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. C cameras, L landmarks, O observations."""

    R: jnp.ndarray          # [C, 3, 3] world-to-camera rotations
    t: jnp.ndarray          # [C, 3]
    X: jnp.ndarray          # [L, 3] world points
    cam_idx: jnp.ndarray    # [O] int32
    lm_idx: jnp.ndarray     # [O] int32
    uv: jnp.ndarray         # [O, 2] normalized-plane measurements
    obs_valid: jnp.ndarray  # [O] bool
    cam_valid: jnp.ndarray  # [C] bool
    lm_valid: jnp.ndarray   # [L] bool


class BAResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    X: jnp.ndarray
    cost: jnp.ndarray       # final robust cost
    initial_cost: jnp.ndarray
    lm_lambda: jnp.ndarray


def _residuals_jacobians(p: BAProblem, R, t, X, huber_delta: float):
    """Per-observation residuals + Jacobians with sqrt-Huber IRLS weights.

    Returns (r [O,2], Jc [O,2,6], Jl [O,2,3], w [O]) already weight-scaled.
    """
    Rc = R[p.cam_idx]                                   # [O, 3, 3]
    tc = t[p.cam_idx]
    Xl = X[p.lm_idx]
    pc = jnp.einsum("oij,oj->oi", Rc, Xl) + tc          # [O, 3] camera frame
    z = pc[:, 2]
    behind = z <= 1e-6
    zs = jnp.where(behind, 1.0, z)
    proj = pc[:, :2] / zs[:, None]
    r = proj - p.uv                                     # [O, 2]

    inv_z = 1.0 / zs
    zeros = jnp.zeros_like(inv_z)
    dpi = jnp.stack([
        jnp.stack([inv_z, zeros, -pc[:, 0] * inv_z * inv_z], -1),
        jnp.stack([zeros, inv_z, -pc[:, 1] * inv_z * inv_z], -1),
    ], -2)                                              # [O, 2, 3]

    dp_dxi = jnp.concatenate([-se3.hat(pc), jnp.broadcast_to(
        jnp.eye(3, dtype=r.dtype), pc.shape[:-1] + (3, 3))], axis=-1)  # [O,3,6]
    Jc = dpi @ dp_dxi                                   # [O, 2, 6]
    Jl = dpi @ Rc                                       # [O, 2, 3]

    valid = p.obs_valid & ~behind
    rn = jnp.linalg.norm(r, axis=-1)
    huber = jnp.sqrt(jnp.minimum(1.0, huber_delta / jnp.maximum(rn, 1e-12)))
    w = jnp.where(valid, huber, 0.0)                    # [O] sqrt-weights
    return r * w[:, None], Jc * w[:, None, None], Jl * w[:, None, None], w


def robust_cost(p: BAProblem, R, t, X, huber_delta: float) -> jnp.ndarray:
    """Huber cost of the current state (for LM accept/reject)."""
    Rc = R[p.cam_idx]
    tc = t[p.cam_idx]
    pc = jnp.einsum("oij,oj->oi", Rc, X[p.lm_idx]) + tc
    z = pc[:, 2]
    behind = z <= 1e-6
    proj = pc[:, :2] / jnp.where(behind, 1.0, z)[:, None]
    r2 = jnp.sum((proj - p.uv) ** 2, axis=-1)
    rn = jnp.sqrt(r2)
    d = huber_delta
    cost = jnp.where(rn <= d, 0.5 * r2, d * (rn - 0.5 * d))
    # out-of-front observations get a fixed penalty (keeps cost comparable)
    cost = jnp.where(behind, d * d, cost)
    return jnp.sum(jnp.where(p.obs_valid, cost, 0.0))


def _inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack([
        jnp.stack([A, B, C], -1),
        jnp.stack([D, E, F], -1),
        jnp.stack([G, H, I], -1),
    ], -2)
    return adj / det[..., None, None]


def normal_equations(p: BAProblem, R, t, X, cfg: BAConfig):
    """Assemble (U [C,6,6], V [L,3,3], bc [C,6], bl [L,3], Wd [C,L,6,3]).

    The camera-landmark coupling Wd is built by a one-hot scatter so the
    whole assembly is segment-sums + matmuls. Under shard_map this runs on
    the LOCAL observation/landmark shard and the caller psums the reduced
    camera system (SURVEY.md §5: Schur assembly with psum over landmark
    contributions)."""
    C = R.shape[0]
    L = X.shape[0]
    r, Jc, Jl, _ = _residuals_jacobians(p, R, t, X, cfg.huber_delta)

    JcT_Jc = jnp.einsum("oai,oaj->oij", Jc, Jc)          # [O, 6, 6]
    JlT_Jl = jnp.einsum("oai,oaj->oij", Jl, Jl)          # [O, 3, 3]
    JcT_r = jnp.einsum("oai,oa->oi", Jc, r)              # [O, 6]
    JlT_r = jnp.einsum("oai,oa->oi", Jl, r)              # [O, 3]
    U = jax.ops.segment_sum(JcT_Jc, p.cam_idx, C)        # [C, 6, 6]
    V = jax.ops.segment_sum(JlT_Jl, p.lm_idx, L)         # [L, 3, 3]
    bc = -jax.ops.segment_sum(JcT_r, p.cam_idx, C)       # [C, 6]
    bl = -jax.ops.segment_sum(JlT_r, p.lm_idx, L)        # [L, 3]

    # camera-landmark coupling: scatter-add over the fused (cam, lm) pair
    # index — O(O) memory/traffic. (Round 1 built this from [O, C] and
    # [O, L] one-hots; the lm one-hot alone is 512 MB at O=16k, L=8k.)
    JcT_Jl = jnp.einsum("oai,oaj->oij", Jc, Jl)          # [O, 6, 3]
    pair = p.cam_idx * L + p.lm_idx                      # [O]
    Wd = jax.ops.segment_sum(JcT_Jl, pair, C * L).reshape(C, L, 6, 3)
    return U, V, bc, bl, Wd


def schur_camera_system(U, V, bc, bl, Wd, lam):
    """Local (partial) reduced camera system before cross-shard reduction.

    Returns (S_partial [C,6,C,6], b_partial [C,6], V_inv [L,3,3]). Damping
    of U is NOT applied here (the caller adds lam*I once, after any psum)."""
    C = U.shape[0]
    eye3 = jnp.eye(3, dtype=U.dtype)
    V_inv = _inv3x3(V + lam * eye3)                      # [L, 3, 3]
    Y = jnp.einsum("clij,ljk->clik", Wd, V_inv)          # [C, L, 6, 3]
    S = -jnp.einsum("clik,dljk->cidj", Y, Wd)            # [C, 6, C, 6]
    S = S.at[jnp.arange(C), :, jnp.arange(C), :].add(U)
    b = bc - jnp.einsum("clik,lk->ci", Y, bl)            # [C, 6]
    return S, b, V_inv


def solve_cameras(S, b, cam_valid, lam, cfg: BAConfig):
    """Damp, gauge-fix, and solve the reduced 6C x 6C camera system.

    solver="schur_dense": direct dense solve (best for small windows);
    solver="schur_cg": Jacobi-preconditioned conjugate gradients on the same
    (SPD) system — the option that scales to large camera counts and to a
    matvec-only distributed formulation."""
    C = cam_valid.shape[0]
    frozen = ~cam_valid
    if cfg.fix_first_camera:
        frozen = frozen | (jnp.arange(C) == 0)
    free = (~frozen).astype(S.dtype)
    mask6 = jnp.repeat(free, 6)
    S2 = S.reshape(6 * C, 6 * C) + lam * jnp.eye(6 * C, dtype=S.dtype)
    S2 = S2 * mask6[:, None] * mask6[None, :]
    S2 = S2 + jnp.diag(1.0 - mask6)                      # identity on frozen
    b2 = b.reshape(-1) * mask6
    if cfg.solver == "schur_cg":
        diag = jnp.diagonal(S2)
        inv_diag = 1.0 / jnp.maximum(diag, 1e-12)
        x, _ = jax.scipy.sparse.linalg.cg(
            lambda v: S2 @ v, b2, M=lambda v: inv_diag * v,
            maxiter=cfg.cg_iters, tol=1e-10)
        return x.reshape(C, 6)
    return jnp.linalg.solve(S2, b2).reshape(C, 6)


def backsub_landmarks(V_inv, bl, Wd, dc, lm_valid):
    """dl = V^-1 (bl - Wd^T dc), masked to valid landmarks."""
    WtD = jnp.einsum("clij,ci->lj", Wd, dc)              # [L, 3]
    dl = jnp.einsum("lij,lj->li", V_inv, bl - WtD)       # [L, 3]
    return dl * lm_valid[:, None]


def apply_increments(R, t, X, dc, dl):
    """Left-multiplicative pose update, additive point update."""
    dR, dt = se3.se3_exp(dc)
    return dR @ R, (dR @ t[..., None])[..., 0] + dt, X + dl


def normal_equations_mf(p: BAProblem, R, t, X, cfg: BAConfig):
    """Matrix-free normal-equation factors: like normal_equations but the
    camera-landmark coupling stays PER-OBSERVATION (Wo [O,6,3]) instead of
    being scattered into the dense [C,L,6,3] block matrix — O(O) memory, so
    the reduced system never materializes at any scale (VERDICT r2 item 4:
    the dense Wd is multiple GB at KITTI-sequence scale).

    Returns (U [C,6,6], V [L,3,3], bc [C,6], bl [L,3], Wo [O,6,3])."""
    C = R.shape[0]
    L = X.shape[0]
    r, Jc, Jl, _ = _residuals_jacobians(p, R, t, X, cfg.huber_delta)

    U = jax.ops.segment_sum(jnp.einsum("oai,oaj->oij", Jc, Jc), p.cam_idx, C)
    V = jax.ops.segment_sum(jnp.einsum("oai,oaj->oij", Jl, Jl), p.lm_idx, L)
    bc = -jax.ops.segment_sum(jnp.einsum("oai,oa->oi", Jc, r), p.cam_idx, C)
    bl = -jax.ops.segment_sum(jnp.einsum("oai,oa->oi", Jl, r), p.lm_idx, L)
    Wo = jnp.einsum("oai,oaj->oij", Jc, Jl)              # [O, 6, 3]
    return U, V, bc, bl, Wo


def schur_matvec_mf(v, U, V_inv, Wo, cam_idx, lm_idx, lam, free6):
    """S·v = (U + lam I)·v − W V⁻¹ Wᵀ·v without materializing S or W:
    two gathers + two segment-sums over observations (the pose graph's
    matrix-free pattern, backend/pose_graph.py, applied to the BA reduced
    system). v: [C, 6]; free6: [C, 6] mask (0 rows/cols for frozen/gauge
    cameras, identity on them)."""
    C = U.shape[0]
    L = V_inv.shape[0]
    vm = v * free6
    a = jnp.einsum("oij,oi->oj", Wo, vm[cam_idx])        # [O, 3]  Wᵀv rows
    q = jax.ops.segment_sum(a, lm_idx, L)                # [L, 3]
    y = jnp.einsum("lij,lj->li", V_inv, q)               # V⁻¹ Wᵀ v
    b = jnp.einsum("oij,oj->oi", Wo, y[lm_idx])          # [O, 6]
    s = jax.ops.segment_sum(b, cam_idx, C)               # [C, 6]  W V⁻¹ Wᵀ v
    Sv = jnp.einsum("cij,cj->ci", U, vm) + lam * vm - s
    # frozen rows act as identity so CG stays well-posed on the full shape
    return Sv * free6 + v * (1.0 - free6)


def solve_cameras_mf(p: BAProblem, U, V_inv, bc, bl, Wo, lam,
                     cfg: BAConfig):
    """Matrix-free Jacobi-preconditioned CG on the reduced camera system.

    Preconditioner: block-Jacobi on (U + lam I) — the exact Schur diagonal
    would need per-(cam,lm) pair aggregation; the U blocks alone are a
    solid approximation since V⁻¹ damps the subtracted term."""
    C = U.shape[0]
    frozen = ~p.cam_valid
    if cfg.fix_first_camera:
        frozen = frozen | (jnp.arange(C) == 0)
    free6 = jnp.where(frozen[:, None], 0.0, 1.0) * jnp.ones((C, 6), U.dtype)

    # reduced RHS: b = bc − W V⁻¹ bl (same segment structure as the matvec)
    ybl = jnp.einsum("lij,lj->li", V_inv, bl)
    wyb = jax.ops.segment_sum(
        jnp.einsum("oij,oj->oi", Wo, ybl[p.lm_idx]), p.cam_idx, C)
    b = (bc - wyb) * free6

    eye6 = jnp.eye(6, dtype=U.dtype)
    Ublk = U + lam * eye6
    # freeze rows -> identity blocks so the batched inverse stays finite
    Ublk = jnp.where(frozen[:, None, None], eye6, Ublk)
    Minv = jnp.linalg.inv(Ublk + 1e-8 * eye6)            # [C, 6, 6]

    def mv(v):
        return schur_matvec_mf(v, U, V_inv, Wo, p.cam_idx, p.lm_idx, lam,
                               free6)

    def prec(v):
        return jnp.einsum("cij,cj->ci", Minv, v) * free6

    x, _ = jax.scipy.sparse.linalg.cg(mv, b, M=prec,
                                      maxiter=cfg.cg_iters, tol=1e-10)
    return x * free6


def backsub_landmarks_mf(p: BAProblem, V_inv, bl, Wo, dc, lm_valid):
    """dl = V⁻¹ (bl − Wᵀ dc) via the per-observation coupling."""
    L = V_inv.shape[0]
    a = jnp.einsum("oij,oi->oj", Wo, dc[p.cam_idx])
    WtD = jax.ops.segment_sum(a, p.lm_idx, L)
    dl = jnp.einsum("lij,lj->li", V_inv, bl - WtD)
    return dl * lm_valid[:, None]


def ba_step(p: BAProblem, R, t, X, lam, cfg: BAConfig):
    """One damped-GN (LM) step: returns proposed (R, t, X)."""
    if cfg.solver == "schur_mf":
        U, V, bc, bl, Wo = normal_equations_mf(p, R, t, X, cfg)
        V_inv = _inv3x3(V + lam * jnp.eye(3, dtype=U.dtype))
        dc = solve_cameras_mf(p, U, V_inv, bc, bl, Wo, lam, cfg)
        dl = backsub_landmarks_mf(p, V_inv, bl, Wo, dc, p.lm_valid)
        return apply_increments(R, t, X, dc, dl)
    U, V, bc, bl, Wd = normal_equations(p, R, t, X, cfg)
    S, b, V_inv = schur_camera_system(U, V, bc, bl, Wd, lam)
    dc = solve_cameras(S, b, p.cam_valid, lam, cfg)
    dl = backsub_landmarks(V_inv, bl, Wd, dc, p.lm_valid)
    return apply_increments(R, t, X, dc, dl)


def run_ba(p: BAProblem, cfg: BAConfig) -> BAResult:
    """Levenberg-Marquardt loop (static iteration count, masked accept).

    Traced under float32 matmul precision: reduced-precision matmul
    passes (bf16, TF32) degrade normal-equation conditioning."""
    with jax.default_matmul_precision("float32"):
        return _run_ba_impl(p, cfg)


def _run_ba_impl(p: BAProblem, cfg: BAConfig) -> BAResult:
    R, t, X = p.R, p.t, p.X
    lam = jnp.asarray(cfg.damping_init, X.dtype)
    cost = robust_cost(p, R, t, X, cfg.huber_delta)
    init_cost = cost

    def body(carry, _):
        R, t, X, lam, cost = carry
        Rn, tn, Xn = ba_step(p, R, t, X, lam, cfg)
        new_cost = robust_cost(p, Rn, tn, Xn, cfg.huber_delta)
        accept = new_cost < cost
        R2 = jnp.where(accept, Rn, R)
        t2 = jnp.where(accept, tn, t)
        X2 = jnp.where(accept, Xn, X)
        cost2 = jnp.where(accept, new_cost, cost)
        lam2 = jnp.where(accept, lam * cfg.damping_down, lam * cfg.damping_up)
        lam2 = jnp.clip(lam2, 1e-9, 1e6)
        return (R2, t2, X2, lam2, cost2), new_cost

    (R, t, X, lam, cost), _ = jax.lax.scan(
        body, (R, t, X, lam, cost), None, length=cfg.iters)
    return BAResult(R=R, t=t, X=X, cost=cost, initial_cost=init_cost,
                    lm_lambda=lam)


run_ba_jit = jax.jit(run_ba, static_argnums=1)


def run_ba_packed(p: BAProblem, cfg: BAConfig) -> jnp.ndarray:
    """run_ba with the result packed into ONE flat f32 buffer
    [C*9 R | C*3 t | L*3 X | cost | initial_cost], so consumers that read
    the result back (the tracker's window-BA flush) fetch a single array
    (one device-to-host copy instead of one per pytree leaf)."""
    res = run_ba(p, cfg)
    return jnp.concatenate([
        res.R.reshape(-1), res.t.reshape(-1), res.X.reshape(-1),
        res.cost[None], res.initial_cost[None]])


def unpack_ba_result(packed, C: int, L: int):
    """Host-side inverse of run_ba_packed: (R[C,3,3], t[C,3], X[L,3],
    cost, initial_cost) as numpy views."""
    import numpy as _np

    a = _np.asarray(packed)
    o = C * 9
    R = a[:o].reshape(C, 3, 3)
    t = a[o:o + C * 3].reshape(C, 3)
    o += C * 3
    X = a[o:o + L * 3].reshape(L, 3)
    o += L * 3
    return R, t, X, float(a[o]), float(a[o + 1])


run_ba_packed_jit = jax.jit(run_ba_packed, static_argnums=1)
