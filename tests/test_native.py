"""Native IO runtime tests (C++ library via ctypes; skipped if the
toolchain can't build it)."""

import numpy as np
import pytest

from visualslam.io import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")

IMAGES = "/root/reference/KeyPointDetection/images"


def test_decode_png_matches_pil():
    from visualslam.utils.images import load_gray

    got = native.decode_gray(f"{IMAGES}/chessboard.png")
    want = load_gray(f"{IMAGES}/chessboard.png")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_decode_jpeg_sane():
    img = native.decode_gray(f"{IMAGES}/home.jpg")
    assert img.shape == (384, 512)
    assert 0.0 <= img.min() and img.max() <= 1.0
    # libjpeg and PIL use slightly different gray conversions; just require
    # strong agreement, not bit-exactness
    from visualslam.utils.images import load_gray

    pil = load_gray(f"{IMAGES}/home.jpg")
    assert np.abs(img - pil).mean() < 0.02


def test_decode_pgm(tmp_path, rng):
    data = (rng.random((10, 12)) * 255).astype(np.uint8)
    p = tmp_path / "t.pgm"
    with open(p, "wb") as f:
        f.write(b"P5 12 10 255\n")
        f.write(data.tobytes())
    img = native.decode_gray(str(p))
    np.testing.assert_allclose(img, data / 255.0, atol=1e-6)


def test_prefetcher_order_and_content():
    paths = [f"{IMAGES}/home.jpg", f"{IMAGES}/blox.jpg",
             f"{IMAGES}/chessboard.png", f"{IMAGES}/building.jpg"] * 3
    pf = native.Prefetcher(paths, capacity=3, n_threads=4)
    frames = list(pf)
    pf.close()
    assert len(frames) == 12
    assert frames[0].shape == (384, 512)
    assert frames[2].shape == (1240, 1754)
    np.testing.assert_array_equal(frames[1], frames[5])  # same file -> same


def test_descriptor_dat_cross_language(tmp_path, rng):
    """C++ writer <-> Python reader and vice versa."""
    from visualslam.io.serialization import (
        load_descriptors_dat,
        save_descriptors_dat,
    )

    d = rng.random((7, 128)).astype(np.float32)
    p1 = str(tmp_path / "cpp.dat")
    native.write_descriptors(p1, d)
    np.testing.assert_array_equal(load_descriptors_dat(p1), d)

    p2 = str(tmp_path / "py.dat")
    save_descriptors_dat(p2, d)
    np.testing.assert_array_equal(native.read_descriptors(p2), d)
