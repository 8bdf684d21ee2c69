"""Harris corner detector frontend.

Reference pipeline (Harris_corners.cpp:146-193 `main`, SURVEY.md §3.1):
grayscale -> 3x3 Gaussian blur -> Sobel ksize=1 -> structure tensor over a
3x3 window -> R = det - 0.04*tr^2 -> keep R > 0 -> 5x5 NMS -> draw.

Here the whole thing is one jitted array program ending in a top-K
selection into a fixed-capacity masked Keypoints set (the reference's
dynamic "store all positive responses" at :60-62 has no static shape).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from visualslam.models.types import Keypoints
from visualslam.ops.blur import gaussian_blur
from visualslam.ops.gradients import central_diff
from visualslam.ops.harris import harris_response
from visualslam.ops.nms import window_peaks
from visualslam.utils.config import HarrisConfig
from visualslam.utils.masked import block_top_k_select


def detect_harris(img: jnp.ndarray, cfg: HarrisConfig) -> Keypoints:
    """Detect Harris corners on a [H, W] float image in [0, 1].

    Returns a fixed-capacity Keypoints (K = cfg.max_keypoints) sorted by
    response, best first. Jit with cfg static."""
    H, W = img.shape
    blurred = gaussian_blur(img, cfg.blur_sigma)
    dx, dy = central_diff(blurred)
    resp = harris_response(dx, dy, cfg.window, cfg.k)
    peaks = window_peaks(resp, cfg.nms_window, cfg.response_threshold)

    flat_scores = resp.reshape(-1)
    flat_valid = peaks.reshape(-1)
    idx, mask = block_top_k_select(flat_scores, flat_valid,
                                   cfg.max_keypoints)
    ys = (idx // W).astype(jnp.float32)
    xs = (idx % W).astype(jnp.float32)
    yx = jnp.stack([ys, xs], axis=-1) * mask[:, None]
    k = cfg.max_keypoints
    return Keypoints(
        yx=yx,
        yx_oct=yx,
        octave=jnp.zeros((k,), jnp.int32),
        level=jnp.zeros((k,), jnp.int32),
        sigma=jnp.full((k,), 1.0, jnp.float32) * mask,
        orientation=jnp.zeros((k,), jnp.float32),
        response=jnp.where(mask, flat_scores[idx], 0.0),
        valid=mask,
    )


detect_harris_jit = jax.jit(detect_harris, static_argnums=1)
