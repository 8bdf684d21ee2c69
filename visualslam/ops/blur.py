"""Separable Gaussian blur as XLA convolutions.

Replaces the reference's per-level cv::GaussianBlur calls
(GaussPyramid.cpp:166-185 `GaussVector`, Harris_corners.cpp:158,
Diff_of_Gauss.cpp:346-348, 621-623). All levels of one
octave are blurred in a single pair of 1-D convolutions by treating the S
sigmas as conv output channels — one horizontal conv [1->S channels] followed
by one vertical depthwise conv [S groups] — so XLA sees two large conv ops
instead of S sequential blurs.

Kernel taps are computed host-side from the static config (sigmas are config
constants), so everything is static-shape under jit.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp

_DN = ("NCHW", "OIHW", "NCHW")


def gaussian_taps(sigma: float, radius: int | None = None,
                  truncate: float = 4.0) -> np.ndarray:
    """1-D normalized Gaussian taps with radius ceil(truncate*sigma)."""
    if radius is None:
        radius = max(1, int(math.ceil(truncate * float(sigma))))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(float(sigma), 1e-12)) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def _pad2d(img: jnp.ndarray, ry: int, rx: int, mode: str) -> jnp.ndarray:
    cfg = [(0, 0)] * (img.ndim - 2) + [(ry, ry), (rx, rx)]
    return jnp.pad(img, cfg, mode=mode)


def blur_stack(img: jnp.ndarray, sigmas: Sequence[float],
               truncate: float = 4.0, mode: str = "symmetric") -> jnp.ndarray:
    """Blur one image with S sigmas at once -> [S, H, W].

    img: [H, W]. The S kernels are zero-padded to a common max radius
    (normalized first, so results equal the per-sigma small-radius blur).
    """
    sigmas = tuple(float(s) for s in sigmas)
    S = len(sigmas)
    radius = max(max(1, int(math.ceil(truncate * s))) for s in sigmas)
    taps = np.zeros((S, 2 * radius + 1), dtype=np.float32)
    for i, s in enumerate(sigmas):
        t = gaussian_taps(s, truncate=truncate)
        r = (len(t) - 1) // 2
        taps[i, radius - r: radius + r + 1] = t
    taps = jnp.asarray(taps)
    K = 2 * radius + 1

    x = _pad2d(img, radius, radius, mode)[None, None]          # [1,1,H+2R,W+2R]
    # Horizontal: 1 -> S channels.
    kh = taps.reshape(S, 1, 1, K)
    x = jax.lax.conv_general_dilated(x, kh, (1, 1), "VALID",
                                     dimension_numbers=_DN)     # [1,S,H+2R,W]
    # Vertical: depthwise over the S channels.
    kv = taps.reshape(S, 1, K, 1)
    x = jax.lax.conv_general_dilated(x, kv, (1, 1), "VALID",
                                     dimension_numbers=_DN,
                                     feature_group_count=S)     # [1,S,H,W]
    return x[0]


@functools.lru_cache(maxsize=64)
def _band_matrices(n: int, taps_key: tuple, R: int) -> np.ndarray:
    """[S, n + 2R, n] banded Toeplitz matrices: column j holds kernel s
    centered at padded row j + R. Cached per (axis length, kernel set)."""
    taps_list = [np.asarray(t, np.float32) for t in taps_key]
    T = np.zeros((len(taps_list), n + 2 * R, n), np.float32)
    for s_i, t in enumerate(taps_list):
        r = (len(t) - 1) // 2
        for j in range(n):
            T[s_i, j + R - r: j + R + r + 1, j] = t
    return T


def blur_stack_matmul(img: jnp.ndarray, sigmas: Sequence[float],
                      truncate: float = 4.0,
                      mode: str = "symmetric") -> jnp.ndarray:
    """blur_stack via banded-Toeplitz matmuls -> [S, H, W].

    Numerically equivalent to the separable convolution (same taps, same
    symmetric border), but expressed as two batched einsums at HIGHEST
    precision, so no backend may round the taps or the image to bf16/TF32
    (the DoG contrast threshold, 0.03, notices ~1e-3 errors).
    """
    sigmas = tuple(float(s) for s in sigmas)
    H, W = img.shape
    taps_key = tuple(
        tuple(gaussian_taps(s, truncate=truncate).tolist()) for s in sigmas)
    R = max((len(t) - 1) // 2 for t in taps_key)
    Tx = jnp.asarray(_band_matrices(W, taps_key, R))   # [S, W+2R, W]
    Ty = jnp.asarray(_band_matrices(H, taps_key, R))   # [S, H+2R, H]

    xp = _pad2d(img, 0, R, mode)                        # [H, W+2R]
    hx = jnp.einsum("hw,swv->shv", xp, Tx,
                    precision=jax.lax.Precision.HIGHEST)   # [S, H, W]
    yp = _pad2d(hx, R, 0, mode)                         # [S, H+2R, W]
    return jnp.einsum("shw,shg->sgw", yp, Ty,
                      precision=jax.lax.Precision.HIGHEST)  # [S, H, W]


def incremental_blur_stack(img: jnp.ndarray, sigmas: Sequence[float],
                           truncate: float = 4.0,
                           mode: str = "symmetric") -> jnp.ndarray:
    """Blur one image to S target sigmas by chaining incremental blurs.

    Mathematically identical to blur_stack (Gaussians compose:
    G_b = G_inc * G_a with inc = sqrt(b^2 - a^2)) but each chained conv has
    a much smaller radius than the absolute-sigma kernels — ~2.4x fewer
    taps/pixel for the SIFT schedule — at the cost of a sequential chain.
    This is the production pyramid path; blur_stack remains the reference-
    shaped one-shot form (GaussPyramid.cpp:166-185 blurs each level from
    the octave base at absolute sigma).
    """
    sigmas = [float(s) for s in sigmas]
    levels = [gaussian_blur(img, sigmas[0], truncate, mode)]
    for prev, cur in zip(sigmas[:-1], sigmas[1:]):
        inc = math.sqrt(max(cur * cur - prev * prev, 1e-12))
        levels.append(gaussian_blur(levels[-1], inc, truncate, mode))
    return jnp.stack(levels, axis=0)


def _band_matrix(taps: jnp.ndarray, n_out: int, n_in: int) -> jnp.ndarray:
    """[S, n_out, n_in] banded convolution matrices: B[s, i, i+k] = taps[s, k].

    Built with a broadcasted gather (no scatter, no host constants) so it
    can be regenerated cheaply inside jit."""
    S, K = taps.shape
    i = jnp.arange(n_out)[:, None]
    j = jnp.arange(n_in)[None, :]
    d = j - i                                           # [n_out, n_in]
    valid = (d >= 0) & (d < K)
    d = jnp.clip(d, 0, K - 1)
    return jnp.where(valid[None], taps[:, d], 0.0)


def matmul_blur_stack(img: jnp.ndarray, sigmas: Sequence[float],
                      truncate: float = 4.0,
                      mode: str = "symmetric") -> jnp.ndarray:
    """blur_stack computed as two banded MATMULS instead of convs.

    y-conv = B_v @ img and x-conv = img @ B_h^T are plain batched
    matmuls, built inside jit from the taps.
    Identical math to blur_stack (same taps, same padding).
    """
    sigmas = tuple(float(s) for s in sigmas)
    S = len(sigmas)
    H, W = img.shape
    radius = max(max(1, int(math.ceil(truncate * s))) for s in sigmas)
    K = 2 * radius + 1
    taps_np = np.zeros((S, K), np.float32)
    for i, s in enumerate(sigmas):
        t = gaussian_taps(s, truncate=truncate)
        r = (len(t) - 1) // 2
        taps_np[i, radius - r: radius + r + 1] = t
    taps = jnp.asarray(taps_np)

    padded = _pad2d(img, radius, radius, mode)          # [H+2R, W+2R]
    Bv = _band_matrix(taps, H, H + 2 * radius)          # [S, H, H+2R]
    Bh = _band_matrix(taps, W, W + 2 * radius)          # [S, W, W+2R]
    v = jnp.einsum("shk,kw->shw", Bv, padded,
                   preferred_element_type=jnp.float32)  # [S, H, W+2R]
    return jnp.einsum("shw,svw->shv", v, Bh,
                      preferred_element_type=jnp.float32)  # [S, H, W]


def gaussian_blur(img: jnp.ndarray, sigma: float, truncate: float = 4.0,
                  mode: str = "symmetric") -> jnp.ndarray:
    """Separable Gaussian blur of [..., H, W] with one sigma."""
    taps = jnp.asarray(gaussian_taps(sigma, truncate=truncate))
    K = taps.shape[0]
    r = (K - 1) // 2
    lead = img.shape[:-2]
    H, W = img.shape[-2:]
    x = _pad2d(img, r, r, mode).reshape((-1, 1) + (H + 2 * r, W + 2 * r))
    x = jax.lax.conv_general_dilated(x, taps.reshape(1, 1, 1, K), (1, 1),
                                     "VALID", dimension_numbers=_DN)
    x = jax.lax.conv_general_dilated(x, taps.reshape(1, 1, K, 1), (1, 1),
                                     "VALID", dimension_numbers=_DN)
    return x.reshape(lead + (H, W))


def box_filter(img: jnp.ndarray, window: int) -> jnp.ndarray:
    """Sum (not mean) over a window x window box, same-size output.

    Used for structure-tensor accumulation (ref Harris_corners.cpp:16-22 is a
    3x3 add loop per pixel). Edge-replicate padded to keep shape.
    """
    r = window // 2
    lead = img.shape[:-2]
    H, W = img.shape[-2:]
    ones = jnp.ones((1, 1, 1, window), img.dtype)
    x = _pad2d(img, r, r, "edge").reshape((-1, 1, H + 2 * r, W + 2 * r))
    x = jax.lax.conv_general_dilated(x, ones, (1, 1), "VALID",
                                     dimension_numbers=_DN)
    x = jax.lax.conv_general_dilated(x, ones.reshape(1, 1, window, 1), (1, 1),
                                     "VALID", dimension_numbers=_DN)
    return x.reshape(lead + (H, W))
