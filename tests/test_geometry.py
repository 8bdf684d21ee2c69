"""Geometry tests: SE(3) algebra identities + synthetic two-view recovery
(SURVEY.md §4: integration tests on synthetic scenes with known ground
truth)."""

import numpy as np

import jax
import jax.numpy as jnp

from visualslam.geometry import se3
from visualslam.geometry.epipolar import (
    eight_point,
    recover_pose,
    sampson_error,
    triangulate,
)
from visualslam.geometry.ransac import estimate_relative_pose
from visualslam.utils.config import RansacConfig


def rot_err_deg(Ra, Rb):
    cos = (np.trace(Ra.T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def make_scene(rng, n=100, w_deg=8.0, t=(0.5, 0.05, 0.1), noise=0.0,
               outliers=0):
    """Random 3D points + two cameras; returns normalized coords + GT."""
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 10], (n, 3))
    w = np.radians(w_deg) * np.array([0.2, 1.0, 0.1])
    w /= max(np.linalg.norm(w) / np.radians(w_deg), 1e-9)
    R = np.asarray(se3.exp_so3(jnp.asarray(w)))
    t = np.asarray(t)
    X2 = X @ R.T + t
    x1 = X[:, :2] / X[:, 2:]
    x2 = X2[:, :2] / X2[:, 2:]
    if noise:
        x1 = x1 + rng.normal(0, noise, x1.shape)
        x2 = x2 + rng.normal(0, noise, x2.shape)
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        x2[idx] = rng.uniform(-0.5, 0.5, (outliers, 2))
    return (jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32),
            R, t, X)


# ---------- SE(3) ----------

def test_so3_exp_log_roundtrip(rng):
    w = rng.standard_normal((64, 3)).astype(np.float32)
    w *= rng.uniform(0, 3.0, (64, 1)) / np.linalg.norm(w, axis=1, keepdims=True)
    R = se3.exp_so3(jnp.asarray(w))
    w2 = np.asarray(se3.log_so3(R))
    np.testing.assert_allclose(w2, w, atol=2e-3)


def test_so3_small_angle():
    w = jnp.asarray([[1e-9, 0, 0]])
    R = se3.exp_so3(w)
    np.testing.assert_allclose(np.asarray(R)[0], np.eye(3), atol=1e-6)


def test_se3_exp_log_roundtrip(rng):
    xi = rng.standard_normal((32, 6)).astype(np.float32) * 0.7
    R, t = se3.se3_exp(jnp.asarray(xi))
    xi2 = np.asarray(se3.se3_log(R, t))
    np.testing.assert_allclose(xi2, xi, atol=2e-3)


def test_se3_compose_inverse(rng):
    xi = rng.standard_normal((6,)).astype(np.float32)
    R, t = se3.se3_exp(jnp.asarray(xi))
    Ri, ti = se3.inverse(R, t)
    Rc, tc = se3.compose(R, t, Ri, ti)
    np.testing.assert_allclose(np.asarray(Rc), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(np.asarray(tc), 0, atol=1e-5)


# ---------- Epipolar ----------

def test_eight_point_noiseless(rng):
    x1, x2, R, t, _ = make_scene(rng, n=60)
    E = eight_point(x1, x2)
    err = np.asarray(sampson_error(E, x1, x2))
    assert err.max() < 1e-8, f"max sampson {err.max():.2e}"


def test_recover_pose_and_triangulate(rng):
    x1, x2, R, t, X = make_scene(rng, n=60)
    E = eight_point(x1, x2)
    w = jnp.ones(x1.shape[0])
    Rr, tr, Xr, front = recover_pose(E, x1, x2, w)
    assert rot_err_deg(np.asarray(Rr), R) < 0.1
    # translation up to scale
    tdir = np.asarray(tr) / np.linalg.norm(np.asarray(tr))
    gt = t / np.linalg.norm(t)
    assert np.abs(tdir @ gt) > 0.999
    assert np.asarray(front).mean() > 0.95
    # triangulation up to the same global scale
    scale = np.linalg.norm(t)
    Xr = np.asarray(Xr) * scale * np.sign(tdir @ gt)
    rel = np.linalg.norm(Xr - X, axis=1) / np.linalg.norm(X, axis=1)
    assert np.median(rel) < 1e-3


def test_triangulate_known_points(rng):
    x1, x2, R, t, X = make_scene(rng, n=40)
    Xt = np.asarray(triangulate(jnp.asarray(R, jnp.float32),
                                jnp.asarray(t, jnp.float32), x1, x2))
    rel = np.linalg.norm(Xt - X, axis=1) / np.linalg.norm(X, axis=1)
    assert np.median(rel) < 1e-4


# ---------- RANSAC ----------

def test_ransac_with_outliers(rng):
    x1, x2, R, t, _ = make_scene(rng, n=150, noise=5e-4, outliers=50)
    valid = jnp.ones(150, bool)
    cfg = RansacConfig(num_hypotheses=256, inlier_threshold=5e-5)
    Rr, tr, Xr, inl, n = estimate_relative_pose(x1, x2, valid, cfg)
    n = int(n)
    assert n >= 80, f"only {n} inliers"
    assert rot_err_deg(np.asarray(Rr), R) < 0.5
    tdir = np.asarray(tr) / np.linalg.norm(np.asarray(tr))
    gt = t / np.linalg.norm(t)
    assert np.abs(tdir @ gt) > 0.995


def test_ransac_respects_validity(rng):
    x1, x2, R, t, _ = make_scene(rng, n=100)
    valid = np.ones(100, bool)
    valid[60:] = False
    # corrupt the invalid region completely
    x2n = np.array(x2)
    x2n[60:] = rng.uniform(-1, 1, (40, 2))
    cfg = RansacConfig(num_hypotheses=128, inlier_threshold=1e-6)
    E, inl, n = __import__("visualslam.geometry.ransac",
                           fromlist=["ransac_essential"]).ransac_essential(
        x1, jnp.asarray(x2n, jnp.float32), jnp.asarray(valid), cfg)
    inl = np.asarray(inl)
    assert not inl[60:].any()
    assert inl[:60].sum() >= 50
