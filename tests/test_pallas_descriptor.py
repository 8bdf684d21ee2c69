"""Parity tests for the fused orientation/descriptor Triton kernels
(ops/pallas/descriptor.py, run by the Pallas interpreter on the CPU)
against the XLA form (crop_patches + tent_sample_patches +
soft_histogram). chip_smoke.py repeats the comparison with the compiled
kernels on the GPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from visualslam.ops.histograms import gaussian_window, soft_histogram
from visualslam.ops.pallas.descriptor import descriptor, orient_hist
from visualslam.ops.patches import (
    crop_patches,
    rotated_grid,
    tent_sample_patches,
)

WIN = 16


def _setup(rng, K=24, L=3, H=96, W=200, margin=10, dtype=np.float32):
    stack = rng.random((L, H, W, 2), dtype=np.float32)
    stack[..., 1] *= 360.0                       # ori channel in [0, 360)
    y = rng.integers(margin, H - margin, K).astype(np.float32)
    x = rng.integers(margin, W - margin, K).astype(np.float32)
    lvl = jnp.asarray(rng.integers(0, L, K).astype(np.int32))
    yx = jnp.asarray(np.stack([y, x], -1))
    levels = jnp.asarray(stack).astype(dtype)
    return levels[..., 0], levels[..., 1], lvl, yx


def _xla_orient(mag, ori, lvl, yx, sigma):
    K = yx.shape[0]
    patches, y0, x0 = crop_patches(
        jnp.stack([mag, ori], -1).astype(jnp.float32), lvl, yx, 28)
    offs = jnp.arange(WIN, dtype=jnp.float32) - WIN // 2
    gy, gx = jnp.meshgrid(offs, offs, indexing="ij")
    grid = jnp.stack([gy, gx], axis=-1)[None]
    both = tent_sample_patches(patches, y0, x0, yx[:, None, None, :] + grid)
    w = gaussian_window(WIN, sigma)
    return soft_histogram(both[..., 1].reshape(K, -1),
                          (both[..., 0] * w).reshape(K, -1), 36, 360.0)


def _xla_desc(mag, ori, lvl, yx, angle):
    K = yx.shape[0]
    patches, y0, x0 = crop_patches(
        jnp.stack([mag, ori], -1).astype(jnp.float32), lvl, yx, 28)
    both = tent_sample_patches(patches, y0, x0,
                               rotated_grid(yx, angle, WIN, step=1.0))
    rel = jnp.mod(both[..., 1] - angle[:, None, None], 360.0)
    cell = WIN // 4

    def to_regions(a):
        a = a.reshape(K, 4, cell, 4, cell)
        return a.transpose(0, 1, 3, 2, 4).reshape(K, 16, cell * cell)

    hist = soft_histogram(to_regions(rel), to_regions(
        both[..., 0] * gaussian_window(WIN, WIN / 2.0)[None]), 8, 360.0)
    return hist.reshape(K, 128)


def test_orient_hist_matches_xla(rng):
    mag, ori, lvl, yx = _setup(rng)
    sigma = jnp.asarray(1.5 + rng.random(yx.shape[0]).astype(np.float32) * 3)
    got = orient_hist(mag, ori, lvl, yx, sigma, 36, interpret=True)
    want = _xla_orient(mag, ori, lvl, yx, sigma)
    assert got.shape == (yx.shape[0], 36)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_descriptor_matches_xla(rng):
    mag, ori, lvl, yx = _setup(rng)
    K = yx.shape[0]
    angle = jnp.asarray(rng.random(K).astype(np.float32) * 360.0)
    # float centers (refined keypoints)
    yxf = yx + jnp.asarray(rng.random((K, 2)).astype(np.float32) - 0.5)
    got = descriptor(mag, ori, lvl, yxf, angle, 4, 8, interpret=True)
    want = _xla_desc(mag, ori, lvl, yxf, angle)
    assert got.shape == (K, 128)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["k_not_block_multiple", "narrow_level",
                                  "image_border", "bf16_levels", "vmapped"])
def test_kernels_edge_cases_match_xla(rng, case):
    """K that fills no whole block (the padded tail is discarded), levels
    narrower than the crop's two 64-pixel segments, windows clamped at
    the level's edges, bfloat16 levels (sampled in float32) and a
    vmapped frame batch."""
    kw = {"k_not_block_multiple": dict(K=13),
          "narrow_level": dict(K=21, H=40, W=94),
          "image_border": dict(K=20, H=48, W=140, margin=1),
          "bf16_levels": dict(K=18, dtype=jnp.bfloat16),
          "vmapped": dict(K=9)}[case]
    mag, ori, lvl, yx = _setup(rng, **kw)
    K = yx.shape[0]
    sigma = jnp.asarray(1.5 + rng.random(K).astype(np.float32) * 3)
    angle = jnp.asarray(rng.random(K).astype(np.float32) * 360.0)
    yxf = yx + jnp.asarray(rng.random((K, 2)).astype(np.float32) - 0.5)

    def both_kernels(m, o):
        return (orient_hist(m, o, lvl, yx, sigma, 36, interpret=True),
                descriptor(m, o, lvl, yxf, angle, 4, 8, interpret=True))

    if case == "vmapped":
        scale = jnp.asarray([1.0, 0.5])
        h, d = jax.vmap(lambda s: both_kernels(mag * s, ori))(scale)
        h, d = h[1], d[1]
        mag = mag * 0.5
    else:
        h, d = both_kernels(mag, ori)
    np.testing.assert_allclose(np.asarray(h), np.asarray(
        _xla_orient(mag, ori, lvl, yx, sigma)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(d), np.asarray(
        _xla_desc(mag, ori, lvl, yxf, angle)), rtol=1e-4, atol=1e-4)


def test_descriptor_rotation_consistency(rng):
    """Same content, angles 0 vs 90: a 90-degree-rotated grid over an
    isotropic Gaussian-weighted window keeps total descriptor mass."""
    mag, ori, lvl, yx = _setup(rng, K=8)
    d0 = descriptor(mag, ori, lvl, yx, jnp.zeros(8), 4, 8, interpret=True)
    d90 = descriptor(mag, ori, lvl, yx, jnp.full(8, 90.0), 4, 8,
                     interpret=True)
    m0 = np.asarray(jnp.sum(d0, axis=1))
    m90 = np.asarray(jnp.sum(d90, axis=1))
    np.testing.assert_allclose(m0, m90, rtol=0.1)


def test_frontend_pallas_patch_impl_matches(rng):
    """detect_and_describe with patch_impl='pallas' reproduces the XLA
    frontend's keypoints and descriptors."""
    from visualslam.frontend import detect_and_describe
    from visualslam.utils.config import DEFAULT_CONFIG

    img = rng.random((120, 160), dtype=np.float32)
    cfg_x = DEFAULT_CONFIG.replace(
        pyramid=DEFAULT_CONFIG.pyramid.replace(num_octaves=2),
        sift=DEFAULT_CONFIG.sift.replace(max_keypoints=256,
                                         max_keypoints_per_octave=128,
                                         patch_impl="xla"))
    cfg_p = cfg_x.replace(sift=cfg_x.sift.replace(patch_impl="pallas"))
    fx = detect_and_describe(jnp.asarray(img), cfg_x)
    fp = detect_and_describe(jnp.asarray(img), cfg_p)
    nx = int(fx.keypoints.count())
    assert nx > 10
    assert abs(int(fp.keypoints.count()) - nx) <= max(2, 0.05 * nx)
    vx = np.asarray(fx.keypoints.valid)
    vp = np.asarray(fp.keypoints.valid)
    # same keypoint set (up to near-tied orientation-peak boundary swaps)
    a = np.asarray(fx.keypoints.yx)[vx]
    b = np.asarray(fp.keypoints.yx)[vp]
    d = np.linalg.norm(a[:, None] - b[None, :], axis=-1)
    assert (d.min(axis=1) < 0.5).mean() > 0.95
    # descriptors of matched keypoints agree
    j = d.argmin(axis=1)
    close = d.min(axis=1) < 1e-3
    dx = np.asarray(fx.descriptors)[vx][close]
    dp = np.asarray(fp.descriptors)[vp][j[close]]
    cos = (dx * dp).sum(1) / np.maximum(
        np.linalg.norm(dx, axis=1) * np.linalg.norm(dp, axis=1), 1e-9)
    assert np.median(cos) > 0.999


def test_frontend_rejects_other_window_sizes_on_kernel_route(rng):
    from visualslam.frontend import detect_and_describe
    from visualslam.utils.config import DEFAULT_CONFIG

    cfg = DEFAULT_CONFIG.replace(sift=DEFAULT_CONFIG.sift.replace(
        patch_impl="pallas", descriptor_window=8))
    with pytest.raises(ValueError, match="16x16"):
        detect_and_describe(jnp.asarray(rng.random((64, 64),
                                                   dtype=np.float32)), cfg)


@pytest.mark.gpu
def test_compiled_kernels_match_interpreter(rng):
    """The Triton-compiled kernels agree with their interpreted run."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernels run only there")
    mag, ori, lvl, yx = _setup(rng, K=40)
    sigma = jnp.full(40, 2.4)
    angle = jnp.asarray(rng.random(40).astype(np.float32) * 360.0)
    for fn, extra in ((orient_hist, sigma), (descriptor, angle)):
        got = fn(mag, ori, lvl, yx, extra)
        want = fn(mag, ori, lvl, yx, extra, interpret=True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
