"""Batched-hypothesis RANSAC for the essential matrix.

Absent in the reference; SURVEY.md §7 "hard parts" prescribes the batched shape:
no early-exit loop — N hypotheses are sampled, solved, and scored in one
vmapped program, then argmax picks the winner and one weighted refit on the
winner's inliers polishes it. Sampling uses Gumbel top-k over the validity
mask, which is vmappable and needs no rejection loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from visualslam.geometry.epipolar import eight_point, recover_pose, sampson_error
from visualslam.utils.config import RansacConfig


def _gumbel_sample_indices(key, valid: jnp.ndarray, n: int) -> jnp.ndarray:
    """Sample n distinct indices from the True entries of valid (w/o
    replacement) via Gumbel top-k. If fewer than n valid entries exist the
    tail indices repeat invalid slots — caller guards via weights."""
    g = jax.random.gumbel(key, valid.shape)
    scores = jnp.where(valid, g, -jnp.inf)
    _, idx = jax.lax.top_k(scores, n)
    return idx


def ransac_essential(x1: jnp.ndarray, x2: jnp.ndarray, valid: jnp.ndarray,
                     cfg: RansacConfig, key=None):
    """Robust essential-matrix estimation.

    x1, x2: [M, 2] normalized-coordinate correspondences; valid: [M] mask.
    Returns (E, inlier_mask [M], num_inliers). Deterministic for a given
    cfg.seed unless an explicit PRNG key is passed.
    """
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    keys = jax.random.split(key, cfg.num_hypotheses)

    if cfg.solver == "5pt":
        from visualslam.geometry.fivepoint import five_point

        def hypothesis(k):
            idx = _gumbel_sample_indices(k, valid, 5)
            cand, cmask = five_point(x1[idx], x2[idx])    # [10, 3, 3]
            errs = jax.vmap(
                lambda E: sampson_error(E, x1, x2))(cand)  # [10, M]
            inls = ((errs < cfg.inlier_threshold) & valid[None]
                    & cmask[:, None])
            counts = jnp.sum(inls, axis=1)
            b = jnp.argmax(counts)
            return cand[b], inls[b], counts[b]
    else:
        def hypothesis(k):
            idx = _gumbel_sample_indices(k, valid, cfg.sample_size)
            E = eight_point(x1[idx], x2[idx])
            err = sampson_error(E, x1, x2)
            inl = (err < cfg.inlier_threshold) & valid
            return E, inl, jnp.sum(inl)

    Es, inls, counts = jax.vmap(hypothesis)(keys)
    best = jnp.argmax(counts)
    E0 = Es[best]
    inl0 = inls[best]

    # Polish: weighted 8-point refit on the winner's inliers, re-scored.
    E1 = eight_point(x1, x2, inl0.astype(x1.dtype))
    err1 = sampson_error(E1, x1, x2)
    inl1 = (err1 < cfg.inlier_threshold) & valid
    use_refit = jnp.sum(inl1) >= jnp.sum(inl0)
    E = jnp.where(use_refit, E1, E0)
    inl = jnp.where(use_refit, inl1, inl0)
    return E, inl, jnp.sum(inl)


def estimate_relative_pose(x1: jnp.ndarray, x2: jnp.ndarray,
                           valid: jnp.ndarray, cfg: RansacConfig, key=None):
    """RANSAC essential + cheirality-checked pose + triangulation.

    Returns (R, t_unit, X [M, 3] in camera-1 frame, inlier_mask, n_inliers).
    Translation is up-to-scale (unit norm)."""
    E, inl, n = ransac_essential(x1, x2, valid, cfg, key)
    R, t, X, front = recover_pose(E, x1, x2, inl.astype(x1.dtype))
    return R, t, X, inl & front, jnp.sum(inl & front)
