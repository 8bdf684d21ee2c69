"""Two-view initialization: the minimum end-to-end slice (SURVEY.md §7).

detect+describe two frames -> match -> RANSAC essential -> pose + structure.
This is the capability the reference's README promises as "Epipolar
Geometry" (README.md:21-22) but never implements — built here as array code:
everything from pixels to pose is one jittable program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from visualslam.frontend import detect_and_describe
from visualslam.geometry.camera import normalized
from visualslam.geometry.ransac import estimate_relative_pose
from visualslam.models.matching import match_features
from visualslam.models.types import Features, Matches
from visualslam.utils.config import SlamConfig


class TwoViewResult(NamedTuple):
    R: jnp.ndarray          # [3, 3] rotation camera1 -> camera2
    t: jnp.ndarray          # [3] unit translation (up to scale)
    points: jnp.ndarray     # [M, 3] triangulated points in camera-1 frame
    matches: Matches        # the matched keypoint pairs
    inliers: jnp.ndarray    # [M] bool epipolar+cheirality inliers
    num_inliers: jnp.ndarray


def two_view_from_features(fa: Features, fb: Features, intr: jnp.ndarray,
                           cfg: SlamConfig, key=None) -> TwoViewResult:
    m = match_features(fa, fb, cfg.match)
    uv1 = fa.keypoints.yx[m.idx_a][:, ::-1]      # (y,x) -> (x,y)
    uv2 = fb.keypoints.yx[m.idx_b][:, ::-1]
    x1 = normalized(uv1, intr)
    x2 = normalized(uv2, intr)
    R, t, X, inl, n = estimate_relative_pose(x1, x2, m.valid, cfg.ransac, key)
    return TwoViewResult(R=R, t=t, points=X, matches=m, inliers=inl,
                         num_inliers=n)


def two_view_reconstruction(img1: jnp.ndarray, img2: jnp.ndarray,
                            intr: jnp.ndarray, cfg: SlamConfig,
                            key=None) -> TwoViewResult:
    """Full pixels-to-pose pipeline on an image pair. Jit with cfg static."""
    fa = detect_and_describe(img1, cfg)
    fb = detect_and_describe(img2, cfg)
    return two_view_from_features(fa, fb, intr, cfg, key)


two_view_reconstruction_jit = jax.jit(two_view_reconstruction,
                                      static_argnums=3)
