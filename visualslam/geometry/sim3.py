"""Sim(3) utilities: similarity transforms for monocular scale drift.

Absent in the reference (no 3D code exists; SURVEY.md §2.3). Monocular SLAM
reconstructs geometry up to scale, and the scale drifts along the trajectory;
loop closures therefore need 7-DoF (Sim(3)) corrections, not 6-DoF
(Strasdat et al., "Scale Drift-Aware Large Scale Monocular SLAM").

Group element: S = (R, t, s) acting on points as  X -> s * R @ X + t.
Tangent: 7-vector xi = [omega (3), nu (3), sigma (1)];
exp uses the closed-form Sim(3) "W" matrix (t = W(omega, sigma) @ nu) with
Taylor guards at theta -> 0 and sigma -> 0 so jax autodiff stays NaN-free
(same jnp.where-with-safe-denominator idiom as geometry/se3.py).

All ops are batched over leading axes and jit-safe.
"""

from __future__ import annotations

import jax.numpy as jnp

from visualslam.geometry.se3 import exp_so3, hat, log_so3

_EPS2 = 1e-8   # threshold on theta^2 / sigma^2 (squared quantities)


def _calc_w_coeffs(theta2: jnp.ndarray, sigma: jnp.ndarray):
    """Coefficients (A, B, C) of W = A*Omega + B*Omega^2 + C*I.

    Shapes: theta2, sigma [...]; returns [..., 1, 1] broadcastable factors.
    Four analytic regimes (sigma ~ 0 or not) x (theta ~ 0 or not), selected
    with nested jnp.where on NaN-safe expressions.
    """
    small_t = theta2 < _EPS2
    small_s = sigma * sigma < _EPS2

    t2s = jnp.where(small_t, 1.0, theta2)          # safe theta^2
    theta = jnp.sqrt(t2s)
    sig_s = jnp.where(small_s, 1.0, sigma)         # safe sigma
    es = jnp.exp(sigma)                            # scale = e^sigma

    # --- sigma ~ 0 ---------------------------------------------------
    C_s0 = jnp.ones_like(sigma) + 0.5 * sigma      # (e^s - 1)/s ~ 1 + s/2
    A_s0_t0 = 0.5 + sigma / 6.0                    # (1-cos t)/t^2 -> 1/2 (+O(s))
    B_s0_t0 = jnp.full_like(sigma, 1.0 / 6.0)
    A_s0 = jnp.where(small_t, A_s0_t0, (1.0 - jnp.cos(theta)) / t2s)
    B_s0 = jnp.where(small_t, B_s0_t0, (theta - jnp.sin(theta)) / (t2s * theta))

    # --- sigma != 0 ---------------------------------------------------
    C_s = (es - 1.0) / sig_s
    # theta ~ 0 limits (from Sophus Sim3 calcW):
    #   A -> ((sigma - 1) e^s + 1) / sigma^2
    #   B -> (e^s (sigma^2/2 - sigma + 1) - 1) / sigma^3
    sig2 = sig_s * sig_s
    A_s_t0 = ((sigma - 1.0) * es + 1.0) / sig2
    B_s_t0 = (es * (0.5 * sig2 - sigma + 1.0) - 1.0) / (sig2 * sig_s)
    a = es * jnp.sin(theta)
    b = es * jnp.cos(theta)
    c = theta2 + sigma * sigma
    c_safe = jnp.where(c < _EPS2, 1.0, c)
    A_s = jnp.where(small_t, A_s_t0,
                    (a * sigma + (1.0 - b) * theta) / (theta * c_safe))
    B_s = jnp.where(small_t, B_s_t0,
                    (C_s - ((b - 1.0) * sigma + a * theta) / c_safe) / t2s)

    A = jnp.where(small_s, A_s0, A_s)[..., None, None]
    B = jnp.where(small_s, B_s0, B_s)[..., None, None]
    C = jnp.where(small_s, C_s0, C_s)[..., None, None]
    return A, B, C


def _calc_w(omega: jnp.ndarray, sigma: jnp.ndarray) -> jnp.ndarray:
    W = hat(omega)
    W2 = W @ W
    theta2 = jnp.sum(omega * omega, axis=-1)
    A, B, C = _calc_w_coeffs(theta2, sigma)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return A * W + B * W2 + C * eye


def sim3_exp(xi: jnp.ndarray):
    """[..., 7] tangent [omega, nu, sigma] -> (R [...,3,3], t [...,3], s [...])."""
    omega = xi[..., :3]
    nu = xi[..., 3:6]
    sigma = xi[..., 6]
    R = exp_so3(omega)
    W = _calc_w(omega, sigma)
    t = (W @ nu[..., None])[..., 0]
    return R, t, jnp.exp(sigma)


def sim3_log(R: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Inverse of sim3_exp -> [..., 7] tangent. W is inverted numerically
    (3x3 solve) — exact and autodiff-friendly."""
    omega = log_so3(R)
    sigma = jnp.log(s)
    W = _calc_w(omega, sigma)
    nu = jnp.linalg.solve(W, t[..., None])[..., 0]
    return jnp.concatenate([omega, nu, sigma[..., None]], axis=-1)


def compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra,ta,sa) . (Rb,tb,sb): apply b then a.  X -> sa Ra (sb Rb X + tb) + ta."""
    return (Ra @ Rb,
            sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta,
            sa * sb)


def inverse(R, t, s):
    Rt = jnp.swapaxes(R, -1, -2)
    inv_s = 1.0 / s
    return Rt, -inv_s[..., None] * (Rt @ t[..., None])[..., 0], inv_s


def transform(R, t, s, X):
    """Apply similarity to points [..., 3]."""
    return s[..., None] * (R @ X[..., None])[..., 0] + t


def relative(Ra, ta, sa, Rb, tb, sb):
    """S_ab = S_a^-1 . S_b (pose of b in a's frame)."""
    Ri, ti, si = inverse(Ra, ta, sa)
    return compose(Ri, ti, si, Rb, tb, sb)


def from_se3(R, t):
    """Lift SE(3) -> Sim(3) with unit scale."""
    return R, t, jnp.ones(R.shape[:-2], R.dtype)
