"""Tests for the scale-space pyramid vs a straightforward NumPy/SciPy golden
implementation of the reference behavior (GaussPyramid.cpp:106-131)."""

import numpy as np
import scipy.ndimage as ndi

import jax.numpy as jnp

from visualslam.models.pyramid import (
    auto_num_octaves,
    build_pyramid,
    build_pyramid_jit,
    level_sigmas,
)
from visualslam.utils.config import PyramidConfig


def golden_pyramid(img: np.ndarray, cfg: PyramidConfig):
    """NumPy re-statement of the spec: absolute-sigma blur from each octave
    base, DoG diffs, stride-2 downsample of level s."""
    base = img
    if cfg.initial_upsample:
        # half-pixel-center bilinear 2x (matches jax.image.resize 'linear')
        base = _upsample2x(img)
    sigmas = level_sigmas(cfg)
    octaves = []
    for _ in range(cfg.num_octaves):
        stack = np.stack([
            ndi.gaussian_filter(base, s, mode="reflect", truncate=cfg.truncate)
            for s in sigmas
        ])
        octaves.append(stack)
        base = stack[cfg.scale_samples][::2, ::2]
    return octaves


def _upsample2x(img):
    h, w = img.shape
    ys = (np.arange(2 * h) + 0.5) / 2.0 - 0.5
    xs = (np.arange(2 * w) + 0.5) / 2.0 - 0.5
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return ndi.map_coordinates(img, [yy, xx], order=1, mode="nearest").astype(
        img.dtype)


def test_level_sigmas_schedule():
    cfg = PyramidConfig()
    s = level_sigmas(cfg)
    assert len(s) == 6
    np.testing.assert_allclose(s[0], 1.6)
    np.testing.assert_allclose(s[3], 3.2, rtol=1e-6)   # k^3 = 2
    np.testing.assert_allclose(s[5], 1.6 * 2 ** (5 / 3), rtol=1e-6)
    # base-image-unit sigma: 2^o * sigma(l)
    np.testing.assert_allclose(cfg.abs_sigma(2, 1), 4 * 1.6 * 2 ** (1 / 3),
                               rtol=1e-6)


def test_auto_num_octaves():
    assert auto_num_octaves(512, 384) == 4   # floor(log2(384)) - 4 = 8 - 4
    assert auto_num_octaves(256, 256) == 4
    assert auto_num_octaves(64, 64) == 2


def test_pyramid_shapes(blox):
    cfg = PyramidConfig(num_octaves=4)
    ss = build_pyramid_jit(jnp.asarray(blox), cfg)
    assert ss.num_octaves == 4 and ss.num_levels == 6
    h, w = 512, 512  # 256x256 upsampled 2x
    for o in range(4):
        assert ss.gauss[o].shape == (6, h >> o, w >> o)
        assert ss.dog[o].shape == (5, h >> o, w >> o)
        # default grad_levels="interior": levels 1..s only
        assert ss.grad_mag[o].shape == (3, h >> o, w >> o)
    assert ss.grad_level_offset == 1


def test_pyramid_grad_levels_all(blox):
    """grad_levels="all" reproduces the reference's full product set
    (GaussPyramid.cpp:65-104 computes gradients for every level)."""
    cfg = PyramidConfig(num_octaves=2, grad_levels="all")
    ss = build_pyramid_jit(jnp.asarray(blox), cfg)
    assert ss.grad_mag[0].shape[0] == 6
    assert ss.grad_level_offset == 0
    # interior mode slices the same values
    ssi = build_pyramid_jit(jnp.asarray(blox),
                            PyramidConfig(num_octaves=2))
    np.testing.assert_allclose(np.asarray(ssi.grad_mag[0]),
                               np.asarray(ss.grad_mag[0][1:4]), atol=1e-6)


def test_pyramid_matches_golden(rng):
    img = rng.random((64, 72)).astype(np.float32)
    cfg = PyramidConfig(num_octaves=3)
    ss = build_pyramid(jnp.asarray(img), cfg)
    gold = golden_pyramid(img, cfg)
    for o in range(3):
        np.testing.assert_allclose(np.asarray(ss.gauss[o]), gold[o], atol=2e-4)
        np.testing.assert_allclose(
            np.asarray(ss.dog[o]), gold[o][1:] - gold[o][:-1], atol=4e-4)


def test_pyramid_dog_consistency(blox):
    cfg = PyramidConfig(num_octaves=2)
    ss = build_pyramid(jnp.asarray(blox), cfg)
    np.testing.assert_allclose(
        np.asarray(ss.dog[0]),
        np.asarray(ss.gauss[0][1:] - ss.gauss[0][:-1]),
        atol=1e-6,
    )
