"""ORB frontend: oriented FAST + rotated BRIEF over an image pyramid.

Roadmap-only in the reference (README.md:19, "Feature description" list;
SURVEY.md §2.3) — designed from scratch as array code:

  - 1.2x image pyramid (static shapes per level, jax.image.resize)
  - dense FAST-9 mask/score per level (ops/fast.py), Harris re-ranking
    (cfg.harris_ranking, as in the original ORB), 3x3 NMS, top-K per level
  - orientation by intensity centroid over a circular 31-px patch
  - rBRIEF: 256 deterministic Gaussian-distributed point pairs (seeded by
    cfg.brief_seed — NOT OpenCV's learned table; documented delta), steered
    by the keypoint angle and sampled bilinearly on a blurred level image
  - bits packed to [K, 8] uint32, matched with the Hamming matmul kernel

Everything is fixed-capacity masked SoA; levels merge via global top-k.
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from visualslam.models.types import Features, Keypoints
from visualslam.ops.blur import gaussian_blur
from visualslam.ops.fast import fast_score_map
from visualslam.ops.gradients import central_diff
from visualslam.ops.harris import harris_response
from visualslam.ops.nms import window_peaks
from visualslam.ops.patches import (
    extract_patches,
    sample_bilinear,
    sample_bilinear_patches,
)
from visualslam.utils.config import OrbConfig
from visualslam.utils.masked import block_top_k_select, top_k_select


def brief_pattern(cfg: OrbConfig) -> np.ndarray:
    """[pairs, 2, 2] (dy, dx) sampling offsets, Gaussian(0, patch/5)-
    distributed, clipped inside the patch (deterministic from brief_seed)."""
    rng = np.random.default_rng(cfg.brief_seed)
    sigma = cfg.patch_size / 5.0
    r = cfg.patch_size // 2 - 1
    pts = rng.normal(0.0, sigma, size=(cfg.brief_pairs, 2, 2))
    return np.clip(pts, -r, r).astype(np.float32)


def _centroid_weights(patch: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Circular-mask moment weights for the intensity centroid."""
    r = patch // 2
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    mask = (ys**2 + xs**2 <= r**2).astype(np.float32)
    return (ys * mask).astype(np.float32), (xs * mask).astype(np.float32), mask


def _detect_level(img: jnp.ndarray, cfg: OrbConfig, k: int):
    """One pyramid level -> (yx [k, 2], score [k], angle [k], valid [k])."""
    is_corner, fast_score = fast_score_map(img, cfg.fast_threshold,
                                           cfg.fast_arc)
    if cfg.harris_ranking:
        dx, dy = central_diff(gaussian_blur(img, 1.0))
        score = harris_response(dx, dy, 3, 0.04)
    else:
        score = fast_score
    score = jnp.where(is_corner, score, -jnp.inf)
    peaks = window_peaks(score, 3, -jnp.inf) & is_corner

    H, W = img.shape
    idx, mask = block_top_k_select(score.reshape(-1), peaks.reshape(-1), k)
    ys = (idx // W).astype(jnp.float32)
    xs = (idx % W).astype(jnp.float32)
    yx = jnp.stack([ys, xs], -1)

    # intensity-centroid orientation (Rosin moments on a circular patch)
    wy, wx, _ = _centroid_weights(cfg.patch_size)
    patches = extract_patches(img, yx, cfg.patch_size)
    m01 = jnp.sum(patches * jnp.asarray(wy), axis=(-2, -1))
    m10 = jnp.sum(patches * jnp.asarray(wx), axis=(-2, -1))
    angle = jnp.degrees(jnp.arctan2(m01, m10))
    angle = jnp.where(angle < 0, angle + 360.0, angle)
    return yx, jnp.where(mask, score.reshape(-1)[idx], 0.0), angle, mask


def _describe_level(img: jnp.ndarray, yx: jnp.ndarray, angle: jnp.ndarray,
                    cfg: OrbConfig) -> jnp.ndarray:
    """Steered BRIEF bits for one level -> [K, pairs/32] uint32."""
    smoothed = gaussian_blur(img, 2.0)
    pat = jnp.asarray(brief_pattern(cfg))                     # [P, 2, 2]
    theta = jnp.deg2rad(angle)
    c, s = jnp.cos(theta), jnp.sin(theta)
    # rotate offsets: (dy, dx) -> R(theta) applied in image coords
    dy, dx = pat[..., 0], pat[..., 1]                          # [P, 2]
    rdx = c[:, None, None] * dx - s[:, None, None] * dy        # [K, P, 2]
    rdy = s[:, None, None] * dx + c[:, None, None] * dy
    coords = (jnp.stack([rdy, rdx], -1)
              + yx[:, None, None, :])                          # [K, P, 2, 2]
    # patch-crop + tent-matmul sampling (see
    # ops/patches.sample_bilinear_patches). patch=44 covers the rotated
    # BRIEF offsets: |offset| <= (patch_size//2 - 1) * sqrt(2) + 0.5.
    # Tiny top-of-pyramid levels fall back to the scattered gather.
    H, W = smoothed.shape
    if min(H, W) >= 44:
        lvl0 = jnp.zeros(yx.shape[0], jnp.int32)
        vals = sample_bilinear_patches(smoothed[None], lvl0, yx, coords,
                                       patch=44)               # [K, P, 2]
    else:
        vals = sample_bilinear(smoothed, coords)
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint32)    # [K, P]
    K, P = bits.shape
    words = bits.reshape(K, P // 32, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1).astype(jnp.uint32)


def detect_and_describe_orb(img: jnp.ndarray, cfg: OrbConfig) -> Features:
    """Full ORB frontend on [H, W] float image in [0, 1]. Jit with cfg
    static."""
    H, W = img.shape
    K = cfg.max_keypoints
    # per-level capacity: proportional to level area, summing ~K total
    areas = [1.0 / (cfg.scale_factor ** (2 * l)) for l in range(cfg.num_levels)]
    total = sum(areas)
    per_level = [max(32, int(round(K * a / total))) for a in areas]

    results = []
    level_img = img
    for l in range(cfg.num_levels):
        scale = cfg.scale_factor ** l
        if l > 0:
            h = int(round(H / scale))
            w = int(round(W / scale))
            level_img = jax.image.resize(img, (h, w), method="linear")
        yx, score, angle, mask = _detect_level(level_img, cfg, per_level[l])
        desc = _describe_level(level_img, yx, angle, cfg)
        results.append((yx * scale, yx, score, angle, mask, desc, l, scale))

    score_all = jnp.concatenate([r[2] for r in results])
    valid_all = jnp.concatenate([r[4] for r in results])
    idx, mask = top_k_select(score_all, valid_all, K)

    yx_base = jnp.concatenate([r[0] for r in results])[idx]
    yx_oct = jnp.concatenate([r[1] for r in results])[idx]
    angle = jnp.concatenate([r[3] for r in results])[idx]
    desc = jnp.concatenate([r[5] for r in results])[idx]
    level = jnp.concatenate([
        jnp.full(r[2].shape, r[6], jnp.int32) for r in results])[idx]
    sigma = jnp.concatenate([
        jnp.full(r[2].shape, r[7], jnp.float32) for r in results])[idx]

    kps = Keypoints(
        yx=yx_base * mask[:, None],
        yx_oct=yx_oct * mask[:, None],
        octave=jnp.where(mask, level, 0),
        level=jnp.where(mask, level, 0),
        sigma=jnp.where(mask, sigma, 0.0),
        orientation=jnp.where(mask, angle, 0.0),
        response=jnp.where(mask, score_all[idx], 0.0),
        valid=mask,
    )
    return Features(kps, desc * mask[:, None].astype(jnp.uint32))


detect_and_describe_orb_jit = jax.jit(detect_and_describe_orb,
                                      static_argnums=1)
