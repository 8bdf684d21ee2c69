"""Orientation histograms and descriptor binning.

Reference: `orientationHistogram` (Diff_of_Gauss.cpp:112-133) builds a
36x10-degree nearest-bin histogram over a 16x16 window; keypoints spawn per
bin > 0.8*max (:357-369); the SIFT descriptor accumulates 16 sub-histograms
of 8 bins (:641-657).

Here histograms are one-hot matmuls (weights [K, P]
contracted against one-hot bin assignments [K, P, B]) instead of per-pixel
scatter loops. Peak angles get parabolic interpolation (reference uses the
raw bin center — documented delta, ours matches the SIFT paper).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def soft_histogram(values: jnp.ndarray, weights: jnp.ndarray, num_bins: int,
                   period: float, interpolate: bool = True,
                   compute_dtype=None) -> jnp.ndarray:
    """Weighted circular histogram over the last axis.

    values: [..., P] in [0, period); weights: [..., P].
    Returns [..., num_bins] float32. With interpolate=True each sample
    splits linearly between its two nearest bins (trilinear-style soft
    binning); with False it's nearest-bin (the reference's quirk (d)
    behavior, minus the bin-36 overflow bug — we wrap).

    The interpolated path evaluates the circular triangle kernel
    tri(pos - center_b) densely and contracts it against the weights with
    one einsum — a single [..., P, B] intermediate a matmul consumes
    directly (the two-one-hot formulation materializes 3x the traffic).
    compute_dtype=jnp.bfloat16 halves that intermediate again;
    accumulation stays float32 (histogram peak ratios tolerate ~1e-2
    relative error; the default float32 path is exact).
    """
    pos = values * (num_bins / period)                      # [..., P] in [0, B)
    if interpolate:
        centers = jnp.arange(num_bins, dtype=pos.dtype) + 0.5
        d = pos[..., None] - centers                        # [..., P, B]
        d = jnp.mod(d + num_bins / 2.0, num_bins) - num_bins / 2.0
        tri = jnp.maximum(0.0, 1.0 - jnp.abs(d))
        if compute_dtype is not None:
            tri = tri.astype(compute_dtype)
            weights = weights.astype(compute_dtype)
        return jnp.einsum("...pb,...p->...b", tri, weights,
                          preferred_element_type=jnp.float32)
    b = jnp.mod(jnp.floor(pos).astype(jnp.int32), num_bins)
    oh = jax.nn.one_hot(b, num_bins, dtype=weights.dtype)
    return jnp.sum(oh * weights[..., None], axis=-2)


def histogram_peaks(hist: jnp.ndarray, num_peaks: int, peak_ratio: float,
                    period: float):
    """Find up to num_peaks circular-local maxima above peak_ratio*max.

    hist: [K, B]. Returns (angles [K, num_peaks] in [0, period),
    peak_values [K, num_peaks], valid [K, num_peaks]). Angles are refined by
    parabolic interpolation over the peak and its two circular neighbors.
    """
    K, B = hist.shape
    left = jnp.roll(hist, 1, axis=-1)
    right = jnp.roll(hist, -1, axis=-1)
    is_peak = (hist > left) & (hist >= right)
    gmax = jnp.max(hist, axis=-1, keepdims=True)
    qualifies = is_peak & (hist >= peak_ratio * gmax) & (gmax > 0)

    scores = jnp.where(qualifies, hist, -jnp.inf)
    top_vals, top_bins = jax.lax.top_k(scores, num_peaks)        # [K, P]
    valid = jnp.isfinite(top_vals)
    top_bins = jnp.where(valid, top_bins, 0)

    h_c = jnp.take_along_axis(hist, top_bins, axis=-1)
    h_l = jnp.take_along_axis(left, top_bins, axis=-1)    # hist[(b-1) % B]
    h_r = jnp.take_along_axis(right, top_bins, axis=-1)   # hist[(b+1) % B]
    denom = h_l - 2.0 * h_c + h_r
    delta = jnp.where(jnp.abs(denom) > 1e-12,
                      0.5 * (h_l - h_r) / jnp.where(denom == 0, 1.0, denom),
                      0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    angles = jnp.mod((top_bins.astype(hist.dtype) + 0.5 + delta)
                     * (period / B), period)
    return angles, jnp.where(valid, top_vals, 0.0), valid


def gaussian_window(size: int, sigma, dtype=jnp.float32) -> jnp.ndarray:
    """[size, size] (or [..., size, size] for batched sigma) Gaussian weight
    window centered on the patch center (ref weights the orientation window
    with sigma = 1.5*sigma(o,l), Diff_of_Gauss.cpp:344-354)."""
    offs = jnp.arange(size, dtype=dtype) - (size - 1) / 2.0
    r2 = offs[:, None] ** 2 + offs[None, :] ** 2
    sigma = jnp.asarray(sigma, dtype)
    return jnp.exp(-r2 / (2.0 * sigma[..., None, None] ** 2))
