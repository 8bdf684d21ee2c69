"""ORB frontend tests: FAST dense op vs cv2 oracle, orientation sanity,
descriptor matching under rotation (Hamming)."""

import numpy as np
import pytest

import jax.numpy as jnp

from visualslam.models.matching import match_features
from visualslam.models.orb import detect_and_describe_orb_jit
from visualslam.ops.fast import fast_score_map
from visualslam.utils.config import MatchConfig, OrbConfig

ORB = OrbConfig(max_keypoints=512, num_levels=4)
HAMMING = MatchConfig(metric="hamming", ratio=0.85, max_matches=512)


def test_fast_mask_overlaps_cv2(home):
    cv2 = pytest.importorskip("cv2")
    img8 = (home * 255).astype(np.uint8)
    det = cv2.FastFeatureDetector_create(threshold=20,
                                         nonmaxSuppression=False)
    cv_kps = det.detect(img8, None)
    cv_yx = {(int(round(kp.pt[1])), int(round(kp.pt[0]))) for kp in cv_kps}
    mask, _ = fast_score_map(jnp.asarray(home), 20 / 255.0, 9)
    ours = np.argwhere(np.asarray(mask))
    ours_set = {tuple(p) for p in ours}
    assert len(cv_yx) > 50
    # cv2 FAST-9 uses a slightly different decision rule near-threshold; ask
    # for strong overlap, not identity.
    inter = len(cv_yx & ours_set)
    assert inter / len(cv_yx) > 0.8, f"overlap {inter / len(cv_yx):.2f}"


def test_orb_detects_and_is_masked(home):
    feats = detect_and_describe_orb_jit(jnp.asarray(home), ORB)
    v = np.asarray(feats.keypoints.valid)
    assert v.sum() > 200
    assert feats.descriptors.dtype == jnp.uint32
    assert feats.descriptors.shape == (512, 8)
    assert np.all(np.asarray(feats.descriptors)[~v] == 0)


def test_orb_orientation_gradient_direction():
    """A bright quadrant corner gives an intensity centroid pointing into
    the bright quadrant (~45 degrees for +y,+x bright)."""
    img = np.full((64, 64), 0.1, np.float32)
    img[32:, 32:] = 0.9  # bright bottom-right quadrant
    cfg = OrbConfig(max_keypoints=16, num_levels=1, fast_threshold=0.05)
    feats = detect_and_describe_orb_jit(jnp.asarray(img), cfg)
    v = np.asarray(feats.keypoints.valid)
    assert v.sum() >= 1
    yx = np.asarray(feats.keypoints.yx)[v]
    # strongest corner near (32, 32)
    assert np.linalg.norm(yx[0] - 32.0) < 3.0
    ang = np.asarray(feats.keypoints.orientation)[v][0]
    # centroid toward +y, +x => atan2(+, +) ~ 45 degrees
    assert 10 < ang < 80, f"angle {ang}"


def test_orb_matching_under_rotation(home):
    cv2 = pytest.importorskip("cv2")
    img = home[:368, :368]
    angle = 20.0
    c = (img.shape[1] / 2 - 0.5, img.shape[0] / 2 - 0.5)
    M = cv2.getRotationMatrix2D(c, angle, 1.0)
    rot = cv2.warpAffine(img, M, img.shape[::-1])

    fa = detect_and_describe_orb_jit(jnp.asarray(img), ORB)
    fb = detect_and_describe_orb_jit(jnp.asarray(rot), ORB)
    m = match_features(fa, fb, HAMMING)
    v = np.asarray(m.valid)
    assert v.sum() >= 40, f"only {v.sum()} matches"
    xy_a = np.asarray(fa.keypoints.yx)[np.asarray(m.idx_a)[v]][:, ::-1]
    xy_b = np.asarray(fb.keypoints.yx)[np.asarray(m.idx_b)[v]][:, ::-1]
    mapped = np.concatenate([xy_a, np.ones((len(xy_a), 1))], 1) @ M.T
    err = np.linalg.norm(mapped - xy_b, axis=1)
    frac = (err < 3.0).mean()
    assert frac > 0.7, f"only {frac:.2f} of ORB matches map correctly"
