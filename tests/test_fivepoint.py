"""5-point minimal essential solver (geometry/fivepoint.py): exact-data
recovery, and the RANSAC payoff — equal-or-better inliers at 1/4 the
hypotheses of the 8-point solver (VERDICT r1 item 8)."""

import numpy as np

import jax
import jax.numpy as jnp

from visualslam.geometry import se3
from visualslam.geometry.epipolar import sampson_error
from visualslam.geometry.fivepoint import five_point
from visualslam.geometry.ransac import ransac_essential
from visualslam.utils.config import RansacConfig


def _scene(rng, n=200, outlier_frac=0.4, noise=5e-4):
    w = rng.normal(0, 0.2, 3)
    R = np.asarray(se3.exp_so3(jnp.asarray(w)))
    t = rng.normal(0, 1, 3)
    t /= np.linalg.norm(t)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:]
    x1 = x1 + rng.normal(0, noise, x1.shape)
    x2 = x2 + rng.normal(0, noise, x2.shape)
    n_out = int(outlier_frac * n)
    out = rng.permutation(n)[:n_out]
    x2[out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    gt_inl = np.ones(n, bool)
    gt_inl[out] = False
    return (jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32),
            gt_inl, R, t)


def test_five_point_exact_recovery(rng):
    """On exact minimal samples the candidate set must contain the true E
    for a large majority of random problems (f32 resultant pipeline)."""
    fp = jax.jit(five_point)
    hits = 0
    for _ in range(20):
        w = rng.normal(0, 0.2, 3)
        R = np.asarray(se3.exp_so3(jnp.asarray(w)))
        t = rng.normal(0, 1, 3)
        t /= np.linalg.norm(t)
        X = rng.uniform([-2, -2, 4], [2, 2, 10], (30, 3))
        x1 = X[:, :2] / X[:, 2:]
        X2 = X @ R.T + t
        x2 = X2[:, :2] / X2[:, 2:]
        Es, valid = fp(jnp.asarray(x1[:5], jnp.float32),
                       jnp.asarray(x2[:5], jnp.float32))
        best = np.inf
        for E, v in zip(np.asarray(Es), np.asarray(valid)):
            if not v:
                continue
            err = np.median(np.asarray(sampson_error(
                jnp.asarray(E), jnp.asarray(x1[5:], jnp.float32),
                jnp.asarray(x2[5:], jnp.float32))))
            best = min(best, float(err))
        hits += best < 1e-6
    assert hits >= 15, f"only {hits}/20 exact recoveries"


def test_five_point_quarter_hypotheses_matches_eight_point(rng):
    """At 40% outliers, 5pt with N/4 hypotheses >= 8pt with N (the minimal
    sample's w^5-vs-w^8 advantage, VERDICT acceptance)."""
    n8, n5 = 128, 32
    wins = 0
    totals = []
    for trial in range(6):
        x1, x2, gt_inl, R, t = _scene(np.random.default_rng(100 + trial))
        v = jnp.ones(x1.shape[0], bool)
        key = jax.random.PRNGKey(trial)
        cfg8 = RansacConfig(num_hypotheses=n8, solver="8pt")
        cfg5 = RansacConfig(num_hypotheses=n5, solver="5pt")
        _, inl8, c8 = ransac_essential(x1, x2, v, cfg8, key)
        _, inl5, c5 = ransac_essential(x1, x2, v, cfg5, key)
        totals.append((int(c5), int(c8)))
        wins += int(c5) >= int(c8) - 2     # tie tolerance: refit jitter
    assert wins >= 4, f"5pt@{n5} vs 8pt@{n8}: {totals}"


def test_five_point_ransac_finds_true_inliers(rng):
    x1, x2, gt_inl, R, t = _scene(np.random.default_rng(7))
    cfg = RansacConfig(num_hypotheses=64, solver="5pt")
    E, inl, n = ransac_essential(x1, x2, jnp.ones(x1.shape[0], bool), cfg)
    inl = np.asarray(inl)
    # all true inliers recovered; false-positive rate bounded by chance
    # epipolar proximity of the box-resampled outliers (the 8pt solver
    # scores ~0.25 fp on this same scene — a scene property, not a solver
    # property)
    assert inl[gt_inl].mean() > 0.9
    assert inl[~gt_inl].mean() < 0.4
