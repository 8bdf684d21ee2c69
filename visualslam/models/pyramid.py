"""Gaussian scale-space pyramid — the array-program `GaussPyramid`.

Reference: the eager C++ class GaussPyramid (GaussPyramid.hpp:14-71,
GaussPyramid.cpp:106-131 `createPyramid`) materializes, at construction, for
every octave: a 6-level Gaussian stack, 5 DoG images, and per-level gradient
products, held in std::map<int, vector<Mat>>. That eager-and-total shape maps
perfectly onto one fused jitted program returning a pytree of arrays
(SURVEY.md §3.3) — which is exactly what `build_pyramid` is.

Details:
  - all 6 levels of an octave are produced by ONE pair of batched 1-D
    blurs (sigmas as a batch axis, ops/blur) instead of 6 sequential ones;
  - sigma schedule is the reference's absolute-from-octave-base rule
    sigma(o, l) = base_sigma * k^l applied to each octave base
    (GaussPyramid.cpp:156-162), k = 2^(1/s), s = 3, levels = s + 3 = 6;
  - octave o+1 base = gauss[s] of octave o, stride-2 downsampled
    (GaussPyramid.cpp:123-126);
  - optional 2x linear upsample of the input before octave 0
    (GaussPyramid.cpp:109-110).

Per-octave arrays have different shapes, so octaves live in a tuple pytree
(static length = cfg.num_octaves); XLA unrolls the (short) octave loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from visualslam.ops.blur import (
    blur_stack,
    blur_stack_matmul,
    incremental_blur_stack,
)
from visualslam.ops.gradients import gradients
from visualslam.ops.resize import downsample2x_nearest, upsample2x_linear
from visualslam.utils.config import PyramidConfig


class ScaleSpace(NamedTuple):
    """Pytree of per-octave stacks. Each field is a tuple (len = num_octaves)
    of arrays shaped [levels, H_o, W_o]; dog stacks are [levels-1, H_o, W_o].

    Mirrors the reference's product set: pyramidGauss / pyramidDiff /
    pyramidGradX/Y / pyramidGradMag / pyramidGradOrient
    (GaussPyramid.hpp:56-63)."""

    gauss: Tuple[jnp.ndarray, ...]
    dog: Tuple[jnp.ndarray, ...]
    grad_x: Tuple[jnp.ndarray, ...]
    grad_y: Tuple[jnp.ndarray, ...]
    grad_mag: Tuple[jnp.ndarray, ...]
    grad_ori: Tuple[jnp.ndarray, ...]

    @property
    def num_octaves(self) -> int:
        return len(self.gauss)

    @property
    def num_levels(self) -> int:
        return self.gauss[0].shape[0]

    @property
    def grad_level_offset(self) -> int:
        """Gauss level of grad stack index 0: 0 when grad_levels="all",
        1 when "interior" (grads cover levels 1..s only)."""
        return 0 if self.grad_mag[0].shape[0] == self.gauss[0].shape[0] else 1


def level_sigmas(cfg: PyramidConfig) -> Tuple[float, ...]:
    """Within-octave absolute sigmas (octave-base pixel units)."""
    return tuple(cfg.base_sigma * cfg.k_factor ** l
                 for l in range(cfg.levels_per_octave))


def auto_num_octaves(h: int, w: int) -> int:
    """floor(log2(min(H, W))) - 4 (ref GaussPyramid.cpp:150-152)."""
    return max(1, int(math.floor(math.log2(min(h, w)))) - 4)


def build_pyramid(img: jnp.ndarray, cfg: PyramidConfig) -> ScaleSpace:
    """Build the full scale space of a single [H, W] image.

    Jit with cfg static:  jax.jit(build_pyramid, static_argnums=1).
    """
    if img.ndim != 2:
        raise ValueError(f"build_pyramid expects [H, W], got {img.shape}")
    img = img.astype(jnp.dtype(cfg.dtype))

    base = upsample2x_linear(img) if cfg.initial_upsample else img
    sigmas = level_sigmas(cfg)
    s = cfg.scale_samples

    if cfg.blur_mode == "incremental":
        blur_fn = incremental_blur_stack
    elif cfg.blur_mode == "conv":
        blur_fn = blur_stack
    elif cfg.blur_mode == "matmul":     # default: banded-Toeplitz einsums
        blur_fn = blur_stack_matmul
    else:
        raise ValueError(f"unknown blur_mode {cfg.blur_mode!r}")
    gauss, dog, gx, gy, gm, go = [], [], [], [], [], []
    for _ in range(cfg.num_octaves):
        stack = blur_fn(base, sigmas, truncate=cfg.truncate)      # [L, H, W]
        gauss.append(stack)
        dog.append(stack[1:] - stack[:-1])                        # [L-1, H, W]
        grad_src = stack if cfg.grad_levels == "all" else stack[1:1 + s]
        dx, dy, mag, ori = gradients(grad_src)
        gx.append(dx)
        gy.append(dy)
        gm.append(mag)
        go.append(ori)
        base = downsample2x_nearest(stack[s])                     # next octave base
    return ScaleSpace(tuple(gauss), tuple(dog), tuple(gx), tuple(gy),
                      tuple(gm), tuple(go))


build_pyramid_jit = jax.jit(build_pyramid, static_argnums=1)
