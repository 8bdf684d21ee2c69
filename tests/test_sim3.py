"""Sim(3) group ops + Sim(3) pose graph (monocular scale-drift correction).

The reference has no 3D code (SURVEY.md §2.3); Sim(3) loop correction is a
north-star component for monocular SLAM where scale drifts along the
trajectory (SURVEY.md §7 hard parts / STATUS.md round-1 gap list).
"""

import numpy as np

import jax
import jax.numpy as jnp

from visualslam.backend.pose_graph import (
    Sim3Graph,
    optimize_sim3_graph_jit,
    sim3_graph_cost,
)
from visualslam.geometry import se3, sim3
from visualslam.utils.config import PoseGraphConfig


# ---------------------------------------------------------------------------
# group ops
# ---------------------------------------------------------------------------

def random_tangents(rng, n=64, scale=1.0):
    xi = rng.normal(0, scale, (n, 7)).astype(np.float32)
    xi[:, 6] = rng.normal(0, 0.3, n)   # keep scales sane (e^sigma)
    # keep |omega| < 2.5: log returns the principal branch, so roundtrip is
    # only an identity for theta < pi (and f32 conditioning degrades near pi)
    wn = np.linalg.norm(xi[:, :3], axis=1, keepdims=True)
    xi[:, :3] *= np.minimum(1.0, 2.5 / np.maximum(wn, 1e-6))
    return jnp.asarray(xi)


def test_sim3_exp_log_roundtrip(rng):
    xi = random_tangents(rng)
    R, t, s = sim3.sim3_exp(xi)
    xi2 = sim3.sim3_log(R, t, s)
    np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi),
                               rtol=1e-4, atol=1e-4)


def test_sim3_exp_small_and_zero_tangents(rng):
    # exact zero and tiny tangents: Taylor-guard regime must be NaN-free
    xi = jnp.concatenate([
        jnp.zeros((1, 7), jnp.float32),
        random_tangents(rng, 8, scale=1e-5),
        # pure scale (theta = 0, sigma != 0)
        jnp.asarray([[0, 0, 0, 0.5, -0.2, 0.1, 0.4]], jnp.float32),
        # pure rotation (sigma = 0)
        jnp.asarray([[0.3, -0.1, 0.2, 0.5, 0, 0, 0]], jnp.float32),
    ])
    R, t, s = sim3.sim3_exp(xi)
    assert np.isfinite(np.asarray(R)).all()
    assert np.isfinite(np.asarray(t)).all()
    xi2 = sim3.sim3_log(R, t, s)
    np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi),
                               rtol=1e-3, atol=1e-5)
    # identity maps to identity
    np.testing.assert_allclose(np.asarray(R[0]), np.eye(3), atol=1e-7)
    np.testing.assert_allclose(np.asarray(s[0]), 1.0, atol=1e-7)


def test_sim3_pure_scale_translation():
    # omega = 0: W = ((e^s - 1)/s) I, so t = (e^s-1)/s * nu
    sig = 0.7
    nu = np.array([1.0, 2.0, -3.0], np.float32)
    xi = jnp.asarray(np.concatenate([[0, 0, 0], nu, [sig]]), jnp.float32)
    R, t, s = sim3.sim3_exp(xi)
    np.testing.assert_allclose(float(s), np.exp(sig), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(t),
                               (np.exp(sig) - 1.0) / sig * nu, rtol=1e-5)


def test_sim3_group_laws(rng):
    xa = random_tangents(rng, 16)
    xb = random_tangents(rng, 16)
    Ra, ta, sa = sim3.sim3_exp(xa)
    Rb, tb, sb = sim3.sim3_exp(xb)
    X = jnp.asarray(rng.normal(0, 2, (16, 3)).astype(np.float32))

    # compose acts like sequential application
    Rc, tc, sc = sim3.compose(Ra, ta, sa, Rb, tb, sb)
    y1 = sim3.transform(Rc, tc, sc, X)
    y2 = sim3.transform(Ra, ta, sa, sim3.transform(Rb, tb, sb, X))
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                               rtol=1e-4, atol=1e-4)

    # inverse undoes transform
    Ri, ti, si = sim3.inverse(Ra, ta, sa)
    y3 = sim3.transform(Ri, ti, si, sim3.transform(Ra, ta, sa, X))
    np.testing.assert_allclose(np.asarray(y3), np.asarray(X),
                               rtol=1e-4, atol=1e-4)


def test_sim3_jacobians_finite(rng):
    # jacfwd through exp at zero must be finite (pose-graph GN relies on it)
    def res(xi):
        R, t, s = sim3.sim3_exp(xi)
        return sim3.sim3_log(R, t, s)

    J = jax.jacfwd(res)(jnp.zeros(7, jnp.float32))
    assert np.isfinite(np.asarray(J)).all()
    np.testing.assert_allclose(np.asarray(J), np.eye(7), atol=1e-4)


# ---------------------------------------------------------------------------
# Sim(3) pose graph
# ---------------------------------------------------------------------------

def circle_trajectory(n=12, radius=5.0):
    Rs, ts = [], []
    for k in range(n):
        a = 2 * np.pi * k / n
        R = np.asarray(se3.exp_so3(jnp.asarray([0.0, 0.0, a])))
        c = radius * np.array([np.cos(a), np.sin(a), 0.0])
        Rs.append(R)
        ts.append(-R @ c)
    return np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)


def build_scale_drift_graph(n=12, drift_per_step=1.05):
    """GT circle at unit scale. The odometry chain accumulates multiplicative
    scale drift (the monocular failure mode); a single loop edge carries the
    true (unit-scale) constraint — exactly the Strasdat Sim(3) setting."""
    R_gt, t_gt = circle_trajectory(n)
    ones = jnp.ones((), jnp.float32)

    # true relative measurements (unit relative scale)
    edges = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0)]
    E = len(edges)
    Rm = np.zeros((E, 3, 3), np.float32)
    tm = np.zeros((E, 3), np.float32)
    sm = np.ones(E, np.float32)
    for k, (a, b) in enumerate(edges):
        Rr, tr, sr = sim3.relative(
            jnp.asarray(R_gt[a]), jnp.asarray(t_gt[a]), ones,
            jnp.asarray(R_gt[b]), jnp.asarray(t_gt[b]), ones)
        Rm[k], tm[k], sm[k] = np.asarray(Rr), np.asarray(tr), float(sr)

    # initial nodes: integrate odometry with per-step scale drift. The
    # drifted chain composes measurement * drift at each step.
    R0 = [R_gt[0]]
    t0 = [t_gt[0]]
    s0 = [1.0]
    for k in range(n - 1):
        d = drift_per_step
        # corrupt the measurement's scale: j's frame shrunk/grown by d
        Rn, tn, sn = sim3.compose(
            jnp.asarray(Rm[k]), jnp.asarray(tm[k]),
            jnp.asarray(np.float32(d)),
            jnp.asarray(R0[-1]), jnp.asarray(t0[-1]),
            jnp.asarray(np.float32(s0[-1])))
        R0.append(np.asarray(Rn))
        t0.append(np.asarray(tn))
        s0.append(float(sn))

    g = Sim3Graph(
        R=jnp.asarray(np.stack(R0)),
        t=jnp.asarray(np.stack(t0)),
        s=jnp.asarray(np.asarray(s0, np.float32)),
        node_valid=jnp.ones(n, bool),
        i=jnp.asarray([e[0] for e in edges], jnp.int32),
        j=jnp.asarray([e[1] for e in edges], jnp.int32),
        Rm=jnp.asarray(Rm), tm=jnp.asarray(tm), sm=jnp.asarray(sm),
        weight=jnp.ones(E, jnp.float32),
        edge_valid=jnp.ones(E, bool),
    )
    return g, R_gt, t_gt


def test_sim3_graph_zero_at_ground_truth():
    g, R_gt, t_gt = build_scale_drift_graph(drift_per_step=1.0)
    c = sim3_graph_cost(g, jnp.asarray(R_gt), jnp.asarray(t_gt),
                        jnp.ones(R_gt.shape[0], jnp.float32))
    assert float(c) < 1e-8


def test_sim3_graph_corrects_scale_drift():
    g, R_gt, t_gt = build_scale_drift_graph(drift_per_step=1.06)
    init = float(sim3_graph_cost(g, g.R, g.t, g.s))
    assert init > 1e-2  # drift actually produced inconsistency

    res = optimize_sim3_graph_jit(g, PoseGraphConfig(iters=25))
    assert float(res.cost) < init * 1e-3, (
        f"cost {init:.3e} -> {float(res.cost):.3e}")

    n = R_gt.shape[0]
    s = np.asarray(res.s)
    # scales pulled back toward the unit gauge of node 0
    assert np.abs(s - 1.0).max() < 0.05, f"scales {s}"
    # camera centers back on the circle
    for k in [n // 3, 2 * n // 3, n - 1]:
        Rk, tk = np.asarray(res.R[k]), np.asarray(res.t[k])
        center = -(1.0 / s[k]) * (Rk.T @ tk)
        gt_center = -R_gt[k].T @ t_gt[k]
        assert np.linalg.norm(center - gt_center) < 0.2, (
            f"node {k}: {center} vs {gt_center}")


def test_sim3_graph_se3_consistency():
    """With unit scales and unit-scale measurements, the Sim(3) graph must
    behave like the SE(3) graph (scale stays ~1)."""
    g, R_gt, t_gt = build_scale_drift_graph(drift_per_step=1.0)
    res = optimize_sim3_graph_jit(g, PoseGraphConfig(iters=5))
    np.testing.assert_allclose(np.asarray(res.s),
                               np.ones(R_gt.shape[0]), atol=1e-4)
