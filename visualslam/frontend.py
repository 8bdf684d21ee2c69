"""Unified detection + description frontend.

The L4 analogue of the reference's two executables (`Harris`
Harris_corners.cpp:146, `DoG` Diff_of_Gauss.cpp:727): one jittable function
`detect_and_describe(img, cfg) -> Features` dispatching on cfg.frontend
("sift" | "orb" | "harris"). Batch over frames with jax.vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from visualslam.models.harris import detect_harris
from visualslam.models.types import Features
from visualslam.utils.config import SlamConfig


def detect_and_describe(img: jnp.ndarray, cfg: SlamConfig) -> Features:
    """img: [H, W] float in [0, 1]. Returns fixed-capacity Features.

    Jit with cfg static: jax.jit(detect_and_describe, static_argnums=1).
    Traced under float32 matmul precision — reduced-precision (bf16/TF32)
    passes add detection jitter that propagates into trajectory error."""
    with jax.default_matmul_precision("float32"):
        return _detect_and_describe(img, cfg)


def _detect_and_describe(img: jnp.ndarray, cfg: SlamConfig) -> Features:
    if img.dtype == jnp.uint8:
        # accept 8-bit frames: host->device transfer is 4x smaller than
        # float32
        img = img.astype(jnp.float32) * (1.0 / 255.0)
    if cfg.frontend == "sift":
        from visualslam.models.sift import detect_and_describe_sift

        return detect_and_describe_sift(img, cfg.pyramid, cfg.sift)
    if cfg.frontend == "orb":
        from visualslam.models.orb import detect_and_describe_orb

        return detect_and_describe_orb(img, cfg.orb)
    if cfg.frontend == "harris":
        kps = detect_harris(img, cfg.harris)
        # Harris is detection-only in the reference; expose raw 16x16 patch
        # vectors as descriptors so matching still works end-to-end.
        from visualslam.ops.patches import extract_patches

        patches = extract_patches(img, kps.yx, 16)
        desc = patches.reshape(kps.capacity, -1)
        norm = jnp.linalg.norm(desc, axis=-1, keepdims=True)
        return Features(kps, desc / jnp.maximum(norm, 1e-8))
    raise ValueError(f"unknown frontend {cfg.frontend!r}")


detect_and_describe_jit = jax.jit(detect_and_describe, static_argnums=1)
