"""Scale-space extrema detection (ops/extrema.py) against brute force."""

import numpy as np
import pytest

import jax.numpy as jnp

from visualslam.ops.extrema import detect_extrema, extrema_mask
from visualslam.utils.config import SiftConfig


def brute_force_mask(dog: np.ndarray) -> np.ndarray:
    """Strict 26-neighbour extrema, one voxel at a time."""
    D, H, W = dog.shape
    out = np.zeros(dog.shape, bool)
    for l in range(1, D - 1):
        for y in range(1, H - 1):
            for x in range(1, W - 1):
                cube = dog[l - 1:l + 2, y - 1:y + 2, x - 1:x + 2].ravel()
                c = cube[13]
                nb = np.delete(cube, 13)
                out[l, y, x] = bool((c > nb).all() or (c < nb).all())
    return out


@pytest.mark.parametrize("shape", [(3, 5, 7), (4, 17, 31), (5, 37, 150),
                                   (6, 29, 13)])
def test_extrema_mask_matches_brute_force(rng, shape):
    dog = rng.standard_normal(shape).astype(np.float32)
    # plateaus: ties must never count as extrema (strict comparison)
    dog[:, ::4, ::3] = np.round(dog[:, ::4, ::3])
    got = np.asarray(extrema_mask(jnp.asarray(dog)))
    np.testing.assert_array_equal(got, brute_force_mask(dog))


def test_detect_extrema_recovers_planted_extrema(rng):
    """Isolated spikes on a flat background are found at their exact
    (level, y, x), with their contrast as score, and nothing else passes
    the contrast threshold."""
    dog = rng.standard_normal((5, 53, 170)).astype(np.float32) * 1e-3
    spikes = [(1, 5, 9, 0.5), (2, 17, 40, -0.8), (3, 30, 120, 0.6),
              (1, 44, 165, 0.4), (2, 50, 20, -0.35)]
    for lv, y, x, v in spikes:
        dog[lv, y, x] = v
    cfg = SiftConfig(contrast_threshold=0.03, edge_r=1e9)
    lvl, yy, xx, off, score, valid = (
        np.asarray(a) for a in detect_extrema(jnp.asarray(dog), cfg,
                                              capacity=16))
    got = {(int(l), int(y), int(x)) for l, y, x in zip(lvl[valid],
                                                       yy[valid], xx[valid])}
    assert got == {(lv, y, x) for lv, y, x, _ in spikes}
    for l, y, x, s in zip(lvl[valid], yy[valid], xx[valid], score[valid]):
        # the quadratic fit of an isolated spike interpolates above |D|
        assert s >= abs(dog[l, y, x]) * 0.99
    assert np.all(np.abs(off[valid]) <= 0.5)
