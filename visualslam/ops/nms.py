"""Non-maximum suppression ops.

Reference has two NMS variants: cv::dilate + equality compare
(Harris_corners.cpp:70-81) and an explicit window max scan (NMS2,
Harris_corners.cpp:83-129, the hot loop at 94-121). The dilate+compare form
is the array-native one — window max is a reduce_window, equality keeps peaks —
so both variants collapse into `window_peaks`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def window_max(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """Sliding window max over the last two axes, same shape (edge-neutral
    padding with -inf)."""
    r = window // 2
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(1,) * (x.ndim - 2) + (window, window),
        window_strides=(1,) * x.ndim,
        padding=[(0, 0)] * (x.ndim - 2) + [(r, r), (r, r)],
    )


def window_peaks(x: jnp.ndarray, window: int,
                 threshold: float = 0.0) -> jnp.ndarray:
    """Boolean mask of strict window-local maxima above threshold.

    Equivalent to the reference's dilate-compare NMS (Harris_corners.cpp:70-81)
    and NMS2 (83-129): a pixel survives iff it equals the window max and
    exceeds `threshold`."""
    return (x >= window_max(x, window)) & (x > threshold)
