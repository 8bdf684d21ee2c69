"""Pose-graph optimization: damped GN on SE(3) relative-pose constraints.

Absent in the reference (BASELINE.json north_star; SURVEY.md §2.3). Design:
fixed-capacity edge SoA, per-edge Jacobians by forward-mode autodiff of the
residual at the identity perturbation (exact, and immune to hand-derived
adjoint sign errors), normal equations assembled with segment_sum over
(i, j) block-pair indices, dense damped solve with node 0 as gauge.

Residual: r_e = log( Tm_e^-1 . T_i^-1 . T_j )  (measurement Tm_e = pose of
j expressed in i's frame), perturbation T_k <- exp(xi_k) T_k.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from visualslam.geometry import se3
from visualslam.utils.config import PoseGraphConfig


class PoseGraph(NamedTuple):
    R: jnp.ndarray          # [N, 3, 3] node rotations (world-to-node or any
    t: jnp.ndarray          # [N, 3]    consistent convention)
    node_valid: jnp.ndarray  # [N]
    i: jnp.ndarray          # [E] int32 source node
    j: jnp.ndarray          # [E] int32 target node
    Rm: jnp.ndarray         # [E, 3, 3] measured relative rotation (j in i)
    tm: jnp.ndarray         # [E, 3]
    weight: jnp.ndarray     # [E] scalar information weight
    edge_valid: jnp.ndarray  # [E]


class PoseGraphResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    cost: jnp.ndarray
    initial_cost: jnp.ndarray


def _edge_residual(xi_i, xi_j, Ri, ti, Rj, tj, Rm, tm):
    dRi, dti = se3.se3_exp(xi_i)
    dRj, dtj = se3.se3_exp(xi_j)
    Ri2 = dRi @ Ri
    ti2 = (dRi @ ti) + dti
    Rj2 = dRj @ Rj
    tj2 = (dRj @ tj) + dtj
    Rrel, trel = se3.relative(Ri2, ti2, Rj2, tj2)   # T_i^-1 T_j
    Rmi, tmi = se3.inverse(Rm, tm)
    Re, te = se3.compose(Rmi, tmi, Rrel, trel)      # Tm^-1 T_i^-1 T_j
    return se3.se3_log(Re, te)


def _residuals_and_jacobians(g: PoseGraph, R, t):
    zero = jnp.zeros(6, R.dtype)

    def one(Ri, ti, Rj, tj, Rm, tm):
        r = _edge_residual(zero, zero, Ri, ti, Rj, tj, Rm, tm)
        Ji = jax.jacfwd(_edge_residual, argnums=0)(
            zero, zero, Ri, ti, Rj, tj, Rm, tm)
        Jj = jax.jacfwd(_edge_residual, argnums=1)(
            zero, zero, Ri, ti, Rj, tj, Rm, tm)
        return r, Ji, Jj

    return jax.vmap(one)(R[g.i], t[g.i], R[g.j], t[g.j], g.Rm, g.tm)


def pose_graph_cost(g: PoseGraph, R, t) -> jnp.ndarray:
    def one(Ri, ti, Rj, tj, Rm, tm):
        zero = jnp.zeros(6, R.dtype)
        return _edge_residual(zero, zero, Ri, ti, Rj, tj, Rm, tm)

    r = jax.vmap(one)(R[g.i], t[g.i], R[g.j], t[g.j], g.Rm, g.tm)
    w = g.weight * g.edge_valid
    return jnp.sum(w * jnp.sum(r * r, axis=-1))


def _solve_graph_system(r, Ji, Jj, i, j, weight, frozen, lam, N, D,
                        solver: str, cg_iters: int):
    """Solve the damped GN normal equations of an edge graph.

    r [E, D]; Ji/Jj [E, D, D]; i/j [E] node ids; weight [E] (0 for invalid
    edges); frozen [N] gauge/invalid mask. Returns dx [N, D].

    solver="dense": materialize H [N*D, N*D] via pair-index segment_sum and
    solve directly — exact, O(N^2 D^2) memory, fine to a few hundred nodes.
    solver="cg": Jacobi-block-preconditioned conjugate gradients where the
    Hessian is never materialized — each matvec is an edge gather + two
    segment_sum scatters, O(E D^2). This is what lets the pose graph scale
    to thousands of keyframes (full KITTI sequences)."""
    w = weight[:, None, None]
    Jiw = Ji * w
    Jjw = Jj * w
    b = (-jax.ops.segment_sum(jnp.einsum("eai,ea->ei", Jiw, r), i, N)
         - jax.ops.segment_sum(jnp.einsum("eai,ea->ei", Jjw, r), j, N))
    free = (~frozen).astype(r.dtype)
    b = b * free[:, None]

    if solver == "dense":
        pairs = (i * N + i, i * N + j, j * N + i, j * N + j)
        blocks = (
            jnp.einsum("eai,eaj->eij", Jiw, Ji),
            jnp.einsum("eai,eaj->eij", Jiw, Jj),
            jnp.einsum("eai,eaj->eij", Jjw, Ji),
            jnp.einsum("eai,eaj->eij", Jjw, Jj),
        )
        H = jnp.zeros((N * N, D, D), r.dtype)
        for blk, pr in zip(blocks, pairs):
            H = H + jax.ops.segment_sum(blk, pr, N * N)
        H = H.reshape(N, N, D, D).transpose(0, 2, 1, 3).reshape(N * D, N * D)
        m = jnp.repeat(free, D)
        H = H * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
        H = H + lam * jnp.eye(N * D, dtype=r.dtype)
        return jnp.linalg.solve(H, b.reshape(-1) * m).reshape(N, D)

    # ---- matrix-free CG ----
    def matvec(v):                     # v [N, D]
        vf = v * free[:, None]         # zero frozen columns
        vi = vf[i]                     # [E, D]
        vj = vf[j]
        yi = jnp.einsum("eab,eb->ea", Ji, vi) + jnp.einsum(
            "eab,eb->ea", Jj, vj)      # J v per edge [E, D]
        out = (jax.ops.segment_sum(
                   jnp.einsum("eai,ea->ei", Jiw, yi), i, N)
               + jax.ops.segment_sum(
                   jnp.einsum("eai,ea->ei", Jjw, yi), j, N))
        out = out * free[:, None] + v * (1.0 - free[:, None])
        return out + lam * vf

    # Jacobi block preconditioner: per-node D x D diagonal blocks
    Hii = (jax.ops.segment_sum(jnp.einsum("eai,eaj->eij", Jiw, Ji), i, N)
           + jax.ops.segment_sum(jnp.einsum("eai,eaj->eij", Jjw, Jj), j, N))
    Hii = Hii + (lam + 1e-8) * jnp.eye(D, dtype=r.dtype)
    Hii = (Hii * free[:, None, None]
           + jnp.eye(D, dtype=r.dtype) * (1.0 - free[:, None, None]))
    Hii_inv = jnp.linalg.inv(Hii)

    def precond(v):
        return jnp.einsum("nij,nj->ni", Hii_inv, v)

    x = jnp.zeros_like(b)
    rr = b
    z = precond(rr)
    p = z
    rz = jnp.vdot(rr, z)

    def body(k, carry):
        x, rr, p, rz = carry
        q = matvec(p)
        alpha = rz / jnp.maximum(jnp.vdot(p, q), 1e-20)
        x2 = x + alpha * p
        r2 = rr - alpha * q
        z2 = precond(r2)
        rz2 = jnp.vdot(r2, z2)
        beta = rz2 / jnp.maximum(rz, 1e-20)
        return x2, r2, z2 + beta * p, rz2

    x, _, _, _ = jax.lax.fori_loop(0, cg_iters, body, (x, rr, p, rz))
    return x * free[:, None]


def _gn_step(g: PoseGraph, R, t, lam, solver: str = "dense",
             cg_iters: int = 64):
    N = R.shape[0]
    r, Ji, Jj = _residuals_and_jacobians(g, R, t)    # [E,6], [E,6,6] x2
    frozen = ~g.node_valid | (jnp.arange(N) == 0)
    dx = _solve_graph_system(r, Ji, Jj, g.i, g.j, g.weight * g.edge_valid,
                             frozen, lam, N, 6, solver, cg_iters)
    dR, dt = se3.se3_exp(dx)
    return dR @ R, (dR @ t[..., None])[..., 0] + dt


def optimize_pose_graph(*args, **kwargs):
    """f32-matmul-precision wrapper of _optimize_pose_graph_highp (default
    bf16/TF32 passes degrade geometric accuracy)."""
    with jax.default_matmul_precision("float32"):
        return _optimize_pose_graph_highp(*args, **kwargs)


def resolve_solver(cfg: PoseGraphConfig, n_nodes: int) -> str:
    if cfg.solver == "auto":
        return "dense" if n_nodes <= cfg.cg_threshold else "cg"
    return cfg.solver


def _optimize_pose_graph_highp(g: PoseGraph, cfg: PoseGraphConfig) -> PoseGraphResult:
    R, t = g.R, g.t
    solver = resolve_solver(cfg, R.shape[0])
    lam = jnp.asarray(cfg.damping, R.dtype)
    cost = pose_graph_cost(g, R, t)
    init = cost

    def body(carry, _):
        R, t, lam, cost = carry
        Rn, tn = _gn_step(g, R, t, lam, solver, cfg.cg_iters)
        cn = pose_graph_cost(g, Rn, tn)
        acc = cn < cost
        R2 = jnp.where(acc, Rn, R)
        t2 = jnp.where(acc, tn, t)
        c2 = jnp.where(acc, cn, cost)
        lam2 = jnp.clip(jnp.where(acc, lam * 0.5, lam * 4.0), 1e-9, 1e4)
        return (R2, t2, lam2, c2), cn

    (R, t, lam, cost), _ = jax.lax.scan(body, (R, t, lam, cost), None,
                                        length=cfg.iters)
    return PoseGraphResult(R=R, t=t, cost=cost, initial_cost=init)


optimize_pose_graph_jit = jax.jit(optimize_pose_graph, static_argnums=1)


# ---------------------------------------------------------------------------
# Sim(3) pose graph — 7-DoF corrections for monocular scale drift
# (Strasdat-style; absent in reference, SURVEY.md §2.3 north star).
# Same design as the SE(3) graph above: autodiff edge Jacobians at the
# identity perturbation, segment_sum block assembly, dense damped solve,
# node 0 frozen as the 7-DoF gauge (fixes global pose AND scale).
# ---------------------------------------------------------------------------

from visualslam.geometry import sim3  # noqa: E402  (keep file top lean)


class Sim3Graph(NamedTuple):
    R: jnp.ndarray          # [N, 3, 3]
    t: jnp.ndarray          # [N, 3]
    s: jnp.ndarray          # [N] per-node scale
    node_valid: jnp.ndarray  # [N]
    i: jnp.ndarray          # [E] int32 source node
    j: jnp.ndarray          # [E] int32 target node
    Rm: jnp.ndarray         # [E, 3, 3] measured relative (j in i)
    tm: jnp.ndarray         # [E, 3]
    sm: jnp.ndarray         # [E] measured relative scale
    weight: jnp.ndarray     # [E]
    edge_valid: jnp.ndarray  # [E]


class Sim3GraphResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    s: jnp.ndarray
    cost: jnp.ndarray
    initial_cost: jnp.ndarray


def _sim3_edge_residual(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    dRi, dti, dsi = sim3.sim3_exp(xi_i)
    dRj, dtj, dsj = sim3.sim3_exp(xi_j)
    Ri2, ti2, si2 = sim3.compose(dRi, dti, dsi, Ri, ti, si)
    Rj2, tj2, sj2 = sim3.compose(dRj, dtj, dsj, Rj, tj, sj)
    Rrel, trel, srel = sim3.relative(Ri2, ti2, si2, Rj2, tj2, sj2)
    # De-conjugation: the measurement was taken in j's era, whose metric is
    # s_j x the gauge metric, so its translation is inflated by s_j
    # (Sim(3) translations are not invariant under scale conjugation:
    # D (R,t,s) D^-1 = (R, s_j t, s) for D = (I,0,s_j)). Dividing by the
    # CURRENT estimate of s_j — inside the residual, so it participates in
    # the Jacobians — makes the edge exact at the consistent solution.
    tm_eff = tm / sj2
    Rmi, tmi, smi = sim3.inverse(Rm, tm_eff, sm)
    Re, te, se = sim3.compose(Rmi, tmi, smi, Rrel, trel, srel)
    return sim3.sim3_log(Re, te, se)


def sim3_graph_cost(g: Sim3Graph, R, t, s) -> jnp.ndarray:
    zero = jnp.zeros(7, R.dtype)

    def one(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        return _sim3_edge_residual(zero, zero, Ri, ti, si, Rj, tj, sj,
                                   Rm, tm, sm)

    r = jax.vmap(one)(R[g.i], t[g.i], s[g.i], R[g.j], t[g.j], s[g.j],
                      g.Rm, g.tm, g.sm)
    w = g.weight * g.edge_valid
    return jnp.sum(w * jnp.sum(r * r, axis=-1))


def _sim3_gn_step(g: Sim3Graph, R, t, s, lam, solver: str = "dense",
                  cg_iters: int = 64):
    N = R.shape[0]
    zero = jnp.zeros(7, R.dtype)

    def one(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        args = (zero, zero, Ri, ti, si, Rj, tj, sj, Rm, tm, sm)
        r = _sim3_edge_residual(*args)
        Ji = jax.jacfwd(_sim3_edge_residual, argnums=0)(*args)
        Jj = jax.jacfwd(_sim3_edge_residual, argnums=1)(*args)
        return r, Ji, Jj

    r, Ji, Jj = jax.vmap(one)(R[g.i], t[g.i], s[g.i], R[g.j], t[g.j],
                              s[g.j], g.Rm, g.tm, g.sm)   # [E,7],[E,7,7]x2
    frozen = ~g.node_valid | (jnp.arange(N) == 0)
    dx = _solve_graph_system(r, Ji, Jj, g.i, g.j, g.weight * g.edge_valid,
                             frozen, lam, N, 7, solver, cg_iters)
    dR, dt, ds = sim3.sim3_exp(dx)
    return sim3.compose(dR, dt, ds, R, t, s)


def optimize_sim3_graph(g: Sim3Graph, cfg: PoseGraphConfig) -> Sim3GraphResult:
    """LM-damped GN on the Sim(3) graph (f32 matmul precision — default
    bf16/TF32 passes degrade geometric accuracy)."""
    with jax.default_matmul_precision("float32"):
        return _optimize_sim3_graph_highp(g, cfg)


def _optimize_sim3_graph_highp(g: Sim3Graph, cfg: PoseGraphConfig):
    R, t, s = g.R, g.t, g.s
    solver = resolve_solver(cfg, R.shape[0])
    lam = jnp.asarray(cfg.damping, R.dtype)
    cost = sim3_graph_cost(g, R, t, s)
    init = cost

    def body(carry, _):
        R, t, s, lam, cost = carry
        Rn, tn, sn = _sim3_gn_step(g, R, t, s, lam, solver, cfg.cg_iters)
        cn = sim3_graph_cost(g, Rn, tn, sn)
        acc = cn < cost
        R2 = jnp.where(acc, Rn, R)
        t2 = jnp.where(acc, tn, t)
        s2 = jnp.where(acc, sn, s)
        c2 = jnp.where(acc, cn, cost)
        lam2 = jnp.clip(jnp.where(acc, lam * 0.5, lam * 4.0), 1e-9, 1e4)
        return (R2, t2, s2, lam2, c2), cn

    (R, t, s, lam, cost), _ = jax.lax.scan(body, (R, t, s, lam, cost), None,
                                           length=cfg.iters)
    return Sim3GraphResult(R=R, t=t, s=s, cost=cost, initial_cost=init)


optimize_sim3_graph_jit = jax.jit(optimize_sim3_graph, static_argnums=1)
