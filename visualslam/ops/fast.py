"""FAST segment-test corner detection.

ORB is roadmap-only in the reference (README.md:19; SURVEY.md §2.3) — this
is a from-scratch array design: the 16-pixel Bresenham circle test is computed
for EVERY pixel simultaneously as 16 shifted image comparisons, and the
"contiguous arc of >= N" test becomes a circular sliding-window sum — all
dense elementwise work, no per-pixel branching.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Bresenham circle of radius 3: 16 (dy, dx) offsets in clockwise order.
CIRCLE16 = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)


def _shifted(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """img shifted so output[y, x] = img[y+dy, x+dx] (edge-replicated)."""
    H, W = img.shape
    pad = jnp.pad(img, 3, mode="edge")
    return jnp.roll(jnp.roll(pad, -dy, axis=0), -dx, axis=1)[3:3 + H, 3:3 + W]


def fast_score_map(img: jnp.ndarray, threshold: float, arc: int = 9):
    """FAST-N corner mask + score for a [H, W] image.

    Returns (is_corner [H, W] bool, score [H, W] float32). Score is the
    sum-of-absolute-differences over the qualifying ring pixels (the common
    ranking score when the exact max-threshold score isn't needed)."""
    ring = jnp.stack([_shifted(img, int(dy), int(dx))
                      for dy, dx in CIRCLE16], axis=0)        # [16, H, W]
    diff = ring - img[None]
    brighter = diff > threshold                               # [16, H, W]
    darker = diff < -threshold

    def has_arc(mask):
        m = mask.astype(jnp.float32)
        # circular sliding-window sum of length `arc` over axis 0
        mm = jnp.concatenate([m, m[: arc - 1]], axis=0)       # [16+arc-1,H,W]
        csum = jnp.cumsum(mm, axis=0)
        csum = jnp.concatenate([jnp.zeros_like(csum[:1]), csum], axis=0)
        win = csum[arc:] - csum[:-arc]                        # [16, H, W]
        return jnp.max(win, axis=0) >= arc

    is_corner = has_arc(brighter) | has_arc(darker)
    score = jnp.sum(jnp.where(brighter | darker,
                              jnp.abs(diff) - threshold, 0.0), axis=0)
    # exclude a 3px border (ring reads are replicated there)
    H, W = img.shape
    yy = jnp.arange(H)[:, None]
    xx = jnp.arange(W)[None, :]
    interior = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return is_corner & interior, score
