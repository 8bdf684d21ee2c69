"""End-to-end frontend tests on real image data: detect -> describe ->
match across a known in-plane transform, and the full two-view program."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from visualslam.frontend import detect_and_describe_jit
from visualslam.models.matching import match_features
from visualslam.slam.two_view import two_view_from_features
from visualslam.utils.config import DEFAULT_CONFIG

CFG = DEFAULT_CONFIG.replace(
    pyramid=DEFAULT_CONFIG.pyramid.replace(num_octaves=3),
    sift=DEFAULT_CONFIG.sift.replace(max_keypoints_per_octave=256,
                                     max_keypoints=512),
)


def test_match_under_known_rotation(home):
    """Detect+describe+match across a 15-degree in-plane rotation; matched
    coordinates must map under the known transform."""
    cv2 = pytest.importorskip("cv2")
    img = home[:368, :368]
    angle = 15.0
    c = (img.shape[1] / 2 - 0.5, img.shape[0] / 2 - 0.5)
    M = cv2.getRotationMatrix2D(c, angle, 1.0)
    rot = cv2.warpAffine(img, M, img.shape[::-1])

    fa = detect_and_describe_jit(jnp.asarray(img), CFG)
    fb = detect_and_describe_jit(jnp.asarray(rot), CFG)
    m = match_features(fa, fb, CFG.match)
    v = np.asarray(m.valid)
    assert v.sum() >= 60, f"only {v.sum()} matches"

    xy_a = np.asarray(fa.keypoints.yx)[np.asarray(m.idx_a)[v]][:, ::-1]
    xy_b = np.asarray(fb.keypoints.yx)[np.asarray(m.idx_b)[v]][:, ::-1]
    ones = np.ones((xy_a.shape[0], 1))
    mapped = np.concatenate([xy_a, ones], 1) @ M.T
    err = np.linalg.norm(mapped - xy_b, axis=1)
    # interior points only (border keypoints can clip out of frame)
    frac_good = (err < 2.0).mean()
    assert frac_good > 0.8, f"only {frac_good:.2f} of matches map correctly"


def test_two_view_synthetic_projections(rng):
    """Full two-view geometry from synthetic Features (bypasses detection):
    exact projections -> recovered pose matches GT."""
    from visualslam.geometry import se3
    from visualslam.models.types import Features, Keypoints

    n = 200
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 10], (n, 3))
    w = np.radians([1.0, 5.0, 0.5])
    R = np.asarray(se3.exp_so3(jnp.asarray(w)))
    t = np.array([0.4, 0.0, 0.1])
    X2 = X @ R.T + t
    intr = jnp.asarray([500.0, 500.0, 320.0, 240.0])
    uv1 = X[:, :2] / X[:, 2:] * 500 + np.array([320, 240])
    uv2 = X2[:, :2] / X2[:, 2:] * 500 + np.array([320, 240])

    # identical random descriptors so matching is exact
    desc = rng.standard_normal((n, 32)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)

    def feats(uv):
        kps = Keypoints.empty(n)._replace(
            yx=jnp.asarray(uv[:, ::-1], jnp.float32),
            valid=jnp.ones(n, bool))
        return Features(kps, jnp.asarray(desc))

    cfg = CFG.replace(match=CFG.match.replace(max_matches=256, ratio=0.9))
    res = two_view_from_features(feats(uv1), feats(uv2), intr, cfg)
    assert int(res.num_inliers) > 150
    Rr = np.asarray(res.R)
    cos = (np.trace(Rr.T @ R) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.2
    tdir = np.asarray(res.t) / np.linalg.norm(np.asarray(res.t))
    assert abs(tdir @ (t / np.linalg.norm(t))) > 0.995
