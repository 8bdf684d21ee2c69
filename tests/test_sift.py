"""SIFT frontend tests: synthetic localization/scale properties + cv2 oracle
overlap + rotation invariance (SURVEY.md §4: numeric + property tests)."""

import numpy as np
import pytest

import jax.numpy as jnp

from visualslam.models.sift import detect_and_describe_sift_jit
from visualslam.utils.config import PyramidConfig, SiftConfig

PYR = PyramidConfig(num_octaves=3)
SIFT = SiftConfig(max_keypoints_per_octave=256, max_keypoints=512)


def blob_image(h, w, centers, sigmas, amp=0.8):
    """Dark background with Gaussian blobs (classic scale-space fixture)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.full((h, w), 0.1)
    for (cy, cx), s in zip(centers, sigmas):
        img += amp * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * s**2))
    return np.clip(img, 0, 1).astype(np.float32)


def run(img, pyr=PYR, sift=SIFT):
    feats = detect_and_describe_sift_jit(jnp.asarray(img), pyr, sift)
    v = np.asarray(feats.keypoints.valid)
    return feats, v


def test_blob_detection_and_localization():
    centers = [(40.0, 40.0), (40.0, 100.0), (100.0, 40.5), (100.5, 100.0)]
    img = blob_image(144, 144, centers, [3.0, 3.0, 3.0, 3.0])
    feats, v = run(img)
    yx = np.asarray(feats.keypoints.yx)[v]
    assert v.sum() >= 4
    for c in centers:
        d = np.linalg.norm(yx - np.asarray(c), axis=1).min()
        assert d < 1.0, f"blob at {c} localized {d:.2f}px off"


def test_blob_scale_estimate():
    """Scale selection: detected sigma tracks blob sigma (LoG theory:
    response peaks at pyramid sigma ~ blob sigma)."""
    for s_blob in [2.5, 5.0]:
        img = blob_image(128, 128, [(64.0, 64.0)], [s_blob])
        feats, v = run(img)
        yx = np.asarray(feats.keypoints.yx)[v]
        sig = np.asarray(feats.keypoints.sigma)[v]
        resp = np.asarray(feats.keypoints.response)[v]
        d = np.linalg.norm(yx - 64.0, axis=1)
        near = d < 3.0
        assert near.any()
        best = np.argmax(resp * near)
        ratio = sig[best] / s_blob
        assert 0.6 < ratio < 1.7, f"sigma {sig[best]:.2f} vs blob {s_blob}"


def test_scale_covariance():
    """Doubling the image doubles the detected scale of the same structure."""
    img1 = blob_image(96, 96, [(48.0, 48.0)], [3.0])
    img2 = blob_image(192, 192, [(96.0, 96.0)], [6.0])
    f1, v1 = run(img1)
    f2, v2 = run(img2)

    def best_sigma(f, v, c):
        yx = np.asarray(f.keypoints.yx)[v]
        sig = np.asarray(f.keypoints.sigma)[v]
        resp = np.asarray(f.keypoints.response)[v]
        near = np.linalg.norm(yx - c, axis=1) < 4.0
        assert near.any()
        return sig[np.argmax(resp * near)]

    s1 = best_sigma(f1, v1, 48.0)
    s2 = best_sigma(f2, v2, 96.0)
    assert 1.5 < s2 / s1 < 2.7, f"scale ratio {s2 / s1:.2f}, want ~2"


def test_descriptor_rotation_invariance(home):
    """Descriptors of the same physical point before/after a 90-degree image
    rotation should be close (rotated grid + orientation normalization)."""
    img = home[:368, :368]  # square crop so 90-deg rotation is shape-safe
    rot = np.rot90(img).copy()
    f1, v1 = run(img)
    f2, v2 = run(rot)
    yx1 = np.asarray(f1.keypoints.yx)[v1]
    d1 = np.asarray(f1.descriptors)[v1]
    yx2 = np.asarray(f2.keypoints.yx)[v2]
    d2 = np.asarray(f2.descriptors)[v2]
    # map rot coords back: rot90 maps (y, x) -> (N-1-x, y); inverse: (y', x')
    # in rot corresponds to original (x', N-1-y')
    n = img.shape[0]
    yx2_in_1 = np.stack([yx2[:, 1], n - 1 - yx2[:, 0]], axis=1)

    from scipy.spatial import cKDTree

    dist, nn = cKDTree(yx2_in_1).query(yx1)
    paired = dist < 1.5
    assert paired.sum() >= 30, f"only {paired.sum()} repeatable keypoints"
    cos = np.sum(d1[paired] * d2[nn[paired]], axis=1)
    frac_good = (cos > 0.8).mean()
    assert frac_good > 0.6, f"only {frac_good:.2f} of pairs descriptor-stable"


def test_cv2_keypoint_overlap(home):
    """Loose oracle: a healthy fraction of OpenCV SIFT's strongest keypoints
    should have a counterpart of ours within 2px (algorithms differ in
    thresholds/edge cases; we check overlap, not identity)."""
    cv2 = pytest.importorskip("cv2")
    img8 = (home * 255).astype(np.uint8)
    det = cv2.SIFT_create(nfeatures=300, contrastThreshold=0.04)
    cv_kps = det.detect(img8, None)
    cv_yx = np.array([[kp.pt[1], kp.pt[0]] for kp in cv_kps])
    feats, v = run(home, PyramidConfig(), SiftConfig())
    yx = np.asarray(feats.keypoints.yx)[v]

    from scipy.spatial import cKDTree

    dist, _ = cKDTree(yx).query(cv_yx)
    frac = (dist < 2.0).mean()
    assert frac > 0.5, f"only {frac:.2f} of cv2 keypoints matched"


def test_masked_slots_zeroed():
    img = blob_image(96, 96, [(48.0, 48.0)], [3.0])
    feats, v = run(img)
    d = np.asarray(feats.descriptors)
    assert np.all(d[~v] == 0)
    assert np.all(np.asarray(feats.keypoints.response)[~v] == 0)
