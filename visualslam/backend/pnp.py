"""Pose-only optimization (motion-only BA / robust PnP refinement).

Used by the tracker: given 3D landmarks and their 2D observations in a new
frame, refine the camera pose with landmarks fixed. Same conventions and
Jacobians as backend/ba.py, but the system is a single damped 6x6 solve per
iteration — tiny, so the whole LM loop is one fused jitted program.
Robustness comes from Huber IRLS weights; an optional inlier mask is
returned for keyframe decisions.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from visualslam.geometry import se3
from visualslam.utils.config import BAConfig


class PnPResult(NamedTuple):
    R: jnp.ndarray          # [3, 3]
    t: jnp.ndarray          # [3]
    inliers: jnp.ndarray    # [N] bool (reprojection error < threshold)
    num_inliers: jnp.ndarray
    cost: jnp.ndarray


def _pose_residuals(R, t, X, uv):
    pc = X @ R.T + t
    z = jnp.maximum(pc[:, 2], 1e-6)
    r = pc[:, :2] / z[:, None] - uv
    return r, pc


def refine_pose(*args, **kwargs):
    """f32-matmul-precision wrapper of _refine_pose_highp (default
    bf16/TF32 passes degrade geometric accuracy)."""
    with jax.default_matmul_precision("float32"):
        return _refine_pose_highp(*args, **kwargs)


def _refine_pose_highp(R0: jnp.ndarray, t0: jnp.ndarray, X: jnp.ndarray,
                uv: jnp.ndarray, valid: jnp.ndarray,
                iters: int = 10, huber_delta: float = 5e-3,
                inlier_threshold: float = 6e-3,
                damping: float = 1e-4) -> PnPResult:
    """Motion-only LM. X: [N, 3] world points; uv: [N, 2] normalized-plane
    measurements; valid: [N]. Returns refined pose + inlier stats."""

    # keep in this function: traced under f32 matmul precision below
    def cost_fn(R, t):
        r, pc = _pose_residuals(R, t, X, uv)
        rn = jnp.linalg.norm(r, axis=-1)
        d = huber_delta
        c = jnp.where(rn <= d, 0.5 * rn * rn, d * (rn - 0.5 * d))
        c = jnp.where(pc[:, 2] <= 1e-6, d * d, c)
        return jnp.sum(jnp.where(valid, c, 0.0))

    def step(R, t, lam):
        r, pc = _pose_residuals(R, t, X, uv)
        z = jnp.maximum(pc[:, 2], 1e-6)
        inv_z = 1.0 / z
        zeros = jnp.zeros_like(inv_z)
        dpi = jnp.stack([
            jnp.stack([inv_z, zeros, -pc[:, 0] * inv_z * inv_z], -1),
            jnp.stack([zeros, inv_z, -pc[:, 1] * inv_z * inv_z], -1),
        ], -2)                                          # [N, 2, 3]
        dp_dxi = jnp.concatenate([
            -se3.hat(pc),
            jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), pc.shape[:-1] + (3, 3)),
        ], axis=-1)                                     # [N, 3, 6]
        J = dpi @ dp_dxi                                # [N, 2, 6]

        rn = jnp.linalg.norm(r, axis=-1)
        w = jnp.sqrt(jnp.minimum(1.0, huber_delta / jnp.maximum(rn, 1e-12)))
        w = jnp.where(valid & (pc[:, 2] > 1e-6), w, 0.0)
        Jw = J * w[:, None, None]
        rw = r * w[:, None]
        H = jnp.einsum("nai,naj->ij", Jw, Jw) + lam * jnp.eye(6, dtype=r.dtype)
        b = -jnp.einsum("nai,na->i", Jw, rw)
        dx = jnp.linalg.solve(H, b)
        dR, dt = se3.se3_exp(dx)
        return dR @ R, (dR @ t) + dt

    def body(carry, _):
        R, t, lam, cost = carry
        Rn, tn = step(R, t, lam)
        cn = cost_fn(Rn, tn)
        acc = cn < cost
        R2 = jnp.where(acc, Rn, R)
        t2 = jnp.where(acc, tn, t)
        c2 = jnp.where(acc, cn, cost)
        lam2 = jnp.clip(jnp.where(acc, lam * 0.3, lam * 5.0), 1e-9, 1e4)
        return (R2, t2, lam2, c2), cn

    lam0 = jnp.asarray(damping, X.dtype)
    (R, t, _, cost), _ = jax.lax.scan(
        body, (R0, t0, lam0, cost_fn(R0, t0)), None, length=iters)

    r, pc = _pose_residuals(R, t, X, uv)
    err = jnp.linalg.norm(r, axis=-1)
    inl = valid & (err < inlier_threshold) & (pc[:, 2] > 1e-6)
    return PnPResult(R=R, t=t, inliers=inl,
                     num_inliers=jnp.sum(inl.astype(jnp.int32)), cost=cost)


refine_pose_jit = jax.jit(refine_pose, static_argnums=(5,))
