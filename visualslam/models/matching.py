"""Descriptor matching: ratio test + mutual-best cross check.

Absent in the reference (README.md:17 roadmap; SURVEY.md §2.3) — designed
from scratch as array code: one distance matmul, min/argmin reductions, and
masked selection produce a fixed-capacity Matches set. No early-exit loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from visualslam.models.types import Features, Matches
from visualslam.ops.distance import hamming_distance_matrix, l2sq_distance_matrix
from visualslam.utils.config import MatchConfig
from visualslam.utils.masked import top_k_select

_BIG = jnp.float32(1e12)


def distance_matrix(fa: Features, fb: Features, metric: str) -> jnp.ndarray:
    if metric == "l2":
        return l2sq_distance_matrix(fa.descriptors, fb.descriptors)
    if metric == "hamming":
        return hamming_distance_matrix(fa.descriptors, fb.descriptors)
    raise ValueError(f"unknown metric {metric!r}")


def match_features(fa: Features, fb: Features, cfg: MatchConfig) -> Matches:
    """Match two fixed-capacity Feature sets -> Matches[cfg.max_matches].

    Lowe ratio test (squared distances for l2, hence ratio^2) and optional
    mutual-best check; matches ranked by distance, best first."""
    va = fa.keypoints.valid
    vb = fb.keypoints.valid
    dist = distance_matrix(fa, fb, cfg.metric)
    dist = jnp.where(va[:, None] & vb[None, :], dist, _BIG)

    # best + second-best per row via three reduction passes (min, argmin,
    # min with the winner masked) rather than lax.top_k(-dist, 2)
    best = jnp.min(dist, axis=1)
    nn = jnp.argmin(dist, axis=1).astype(jnp.int32)
    cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    second = jnp.min(jnp.where(cols == nn[:, None], _BIG, dist), axis=1)

    ratio = cfg.ratio ** 2 if cfg.metric == "l2" else cfg.ratio
    ok = va & (best < _BIG) & (best < ratio * second)

    if cfg.mutual:
        col_best = jnp.argmin(dist, axis=0)            # [Kb]
        ok &= col_best[nn] == jnp.arange(dist.shape[0])

    m = cfg.max_matches
    idx, mask = top_k_select(-best, ok, m)
    return Matches(
        idx_a=jnp.where(mask, idx, 0).astype(jnp.int32),
        idx_b=jnp.where(mask, nn[idx], 0).astype(jnp.int32),
        distance=jnp.where(mask, best[idx], 0.0),
        valid=mask,
    )


match_features_jit = jax.jit(match_features, static_argnums=2)
