"""Harris detector frontend tests (ref behavior: Harris_corners.cpp:146-193)."""

import numpy as np

import jax
import jax.numpy as jnp

from visualslam.models.harris import detect_harris, detect_harris_jit
from visualslam.utils.config import HarrisConfig


def checkerboard(n=96, sq=12):
    y, x = np.mgrid[0:n, 0:n]
    return (((y // sq) + (x // sq)) % 2).astype(np.float32)


def test_harris_finds_checkerboard_corners():
    img = checkerboard()
    cfg = HarrisConfig(max_keypoints=256)
    kps = detect_harris_jit(jnp.asarray(img), cfg)
    n = int(kps.count())
    # interior corner lattice is 7x7 = 49
    assert n >= 30, f"only {n} corners found"
    yx = np.asarray(kps.yx)[np.asarray(kps.valid)]
    # every detection within 2px of a lattice point (multiples of 12)
    err = np.abs((yx + 6.0) % 12.0 - 6.0).max()
    assert err <= 2.0, f"corner localization error {err}"


def test_harris_response_sorted_and_masked():
    img = checkerboard()
    cfg = HarrisConfig(max_keypoints=512)
    kps = detect_harris(jnp.asarray(img), cfg)
    r = np.asarray(kps.response)
    v = np.asarray(kps.valid)
    assert (np.diff(r[v]) <= 1e-6).all()          # best-first
    assert (r[~v] == 0).all()
    assert v[: int(v.sum())].all()                 # valid prefix contiguous


def test_harris_flat_image_no_corners():
    img = np.full((64, 64), 0.5, np.float32)
    kps = detect_harris(jnp.asarray(img), HarrisConfig())
    assert int(kps.count()) == 0


def test_harris_vmaps():
    imgs = jnp.stack([jnp.asarray(checkerboard()),
                      jnp.asarray(checkerboard(sq=16))])
    cfg = HarrisConfig(max_keypoints=128)
    kps = jax.vmap(lambda im: detect_harris(im, cfg))(imgs)
    assert kps.yx.shape == (2, 128, 2)
    assert int(kps.count()) > 0
