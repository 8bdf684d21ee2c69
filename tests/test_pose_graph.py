"""Pose-graph optimization tests: loop-closure correction on synthetic
trajectories with drift."""

import numpy as np

import jax.numpy as jnp

from visualslam.backend.pose_graph import (
    PoseGraph,
    optimize_pose_graph_jit,
    pose_graph_cost,
)
from visualslam.geometry import se3
from visualslam.utils.config import PoseGraphConfig


def circle_trajectory(n=12, radius=5.0):
    """Ground-truth poses around a circle (node k at angle 2pi k/n)."""
    Rs, ts = [], []
    for k in range(n):
        a = 2 * np.pi * k / n
        w = np.array([0.0, 0.0, a])
        R = np.asarray(se3.exp_so3(jnp.asarray(w)))
        c = radius * np.array([np.cos(a), np.sin(a), 0.0])
        Rs.append(R)
        ts.append(-R @ c)
    return np.stack(Rs), np.stack(ts)


def relative_meas(Ra, ta, Rb, tb):
    Rr, tr = se3.relative(jnp.asarray(Ra), jnp.asarray(ta),
                          jnp.asarray(Rb), jnp.asarray(tb))
    return np.asarray(Rr), np.asarray(tr)


def build_graph(rng, n=12, drift=0.03, with_loop=True):
    R_gt, t_gt = circle_trajectory(n)
    # odometry edges with exact measurements
    edges = [(k, k + 1) for k in range(n - 1)]
    if with_loop:
        edges.append((n - 1, 0))
    E = len(edges)
    i = np.array([e[0] for e in edges], np.int32)
    j = np.array([e[1] for e in edges], np.int32)
    Rm = np.zeros((E, 3, 3), np.float32)
    tm = np.zeros((E, 3), np.float32)
    for k, (a, b) in enumerate(edges):
        Rm[k], tm[k] = relative_meas(R_gt[a], t_gt[a], R_gt[b], t_gt[b])

    # initial guess: integrate odometry with injected drift
    R0 = [R_gt[0]]
    t0 = [t_gt[0]]
    for k in range(n - 1):
        xi = rng.normal(0, drift, 6).astype(np.float32)
        dR, dt = se3.se3_exp(jnp.asarray(xi))
        Rn, tn = se3.compose(jnp.asarray(np.asarray(dR) @ Rm[k]),
                             jnp.asarray(np.asarray(dR) @ tm[k] + np.asarray(dt)),
                             jnp.asarray(R0[-1]), jnp.asarray(t0[-1]))
        R0.append(np.asarray(Rn))
        t0.append(np.asarray(tn))

    g = PoseGraph(
        R=jnp.asarray(np.stack(R0), jnp.float32),
        t=jnp.asarray(np.stack(t0), jnp.float32),
        node_valid=jnp.ones(n, bool),
        i=jnp.asarray(i), j=jnp.asarray(j),
        Rm=jnp.asarray(Rm), tm=jnp.asarray(tm),
        weight=jnp.ones(E, jnp.float32),
        edge_valid=jnp.ones(E, bool),
    )
    return g, R_gt, t_gt


def test_pose_graph_zero_at_ground_truth(rng):
    g, R_gt, t_gt = build_graph(rng, drift=0.0)
    c = pose_graph_cost(g, jnp.asarray(R_gt, jnp.float32),
                        jnp.asarray(t_gt, jnp.float32))
    assert float(c) < 1e-8


def test_pose_graph_corrects_drift(rng):
    g, R_gt, t_gt = build_graph(rng, drift=0.04)
    init = float(pose_graph_cost(g, g.R, g.t))
    res = optimize_pose_graph_jit(g, PoseGraphConfig(iters=15))
    assert float(res.cost) < init * 1e-3, (
        f"cost {init:.3e} -> {float(res.cost):.3e}")
    # centers must be back near the circle (gauge: node 0 fixed = GT here)
    for k in [4, 8, 11]:
        Rk = np.asarray(res.R[k])
        tk = np.asarray(res.t[k])
        center = -Rk.T @ tk
        gt_center = -R_gt[k].T @ t_gt[k]
        assert np.linalg.norm(center - gt_center) < 0.15, (
            f"node {k} center off by {np.linalg.norm(center - gt_center):.3f}")


def test_pose_graph_ignores_invalid_edges(rng):
    g, *_ = build_graph(rng, drift=0.02)
    E = g.i.shape[0]
    # append a wildly wrong but invalid edge
    g2 = PoseGraph(
        R=g.R, t=g.t, node_valid=g.node_valid,
        i=jnp.concatenate([g.i, jnp.asarray([0], jnp.int32)]),
        j=jnp.concatenate([g.j, jnp.asarray([5], jnp.int32)]),
        Rm=jnp.concatenate([g.Rm, jnp.eye(3, dtype=jnp.float32)[None]]),
        tm=jnp.concatenate([g.tm, jnp.asarray([[99.0, 0, 0]])]),
        weight=jnp.concatenate([g.weight, jnp.asarray([10.0])]),
        edge_valid=jnp.concatenate([g.edge_valid, jnp.asarray([False])]),
    )
    r1 = optimize_pose_graph_jit(g, PoseGraphConfig(iters=10))
    r2 = optimize_pose_graph_jit(g2, PoseGraphConfig(iters=10))
    np.testing.assert_allclose(np.asarray(r1.t), np.asarray(r2.t), atol=1e-4)
