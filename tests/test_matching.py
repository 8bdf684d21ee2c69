"""Matching tests: distance matrices vs NumPy goldens, ratio/mutual logic."""

import numpy as np
import pytest

import jax.numpy as jnp

from visualslam.models.matching import match_features
from visualslam.models.types import Features, Keypoints
from visualslam.ops.distance import (
    hamming_distance_matrix,
    l2sq_distance_matrix,
    unpack_bits,
)
from visualslam.utils.config import MatchConfig


def make_features(desc, valid=None):
    k = desc.shape[0]
    kps = Keypoints.empty(k)
    if valid is None:
        valid = np.ones(k, bool)
    kps = kps._replace(valid=jnp.asarray(valid))
    return Features(kps, jnp.asarray(desc))


def test_l2sq_matches_numpy(rng):
    a = rng.standard_normal((17, 32)).astype(np.float32)
    b = rng.standard_normal((23, 32)).astype(np.float32)
    got = np.asarray(l2sq_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    want = ((a[:, None] - b[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_hamming_matches_numpy(rng):
    a = rng.integers(0, 2**32, (9, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (11, 8), dtype=np.uint32)
    got = np.asarray(hamming_distance_matrix(jnp.asarray(a), jnp.asarray(b)))
    ua = np.unpackbits(a.view(np.uint8), bitorder="little").reshape(9, -1)
    ub = np.unpackbits(b.view(np.uint8), bitorder="little").reshape(11, -1)
    want = (ua[:, None] != ub[None]).sum(-1)
    np.testing.assert_array_equal(got.astype(int), want)


def test_unpack_bits_roundtrip(rng):
    a = rng.integers(0, 2**32, (4, 2), dtype=np.uint32)
    bits = np.asarray(unpack_bits(jnp.asarray(a)))
    want = np.unpackbits(a.view(np.uint8), bitorder="little").reshape(4, -1)
    np.testing.assert_array_equal(bits.astype(np.uint8), want)


def test_match_identity_permutation(rng):
    """Descriptors = shuffled copies -> perfect matching recovers the
    permutation."""
    d = rng.standard_normal((32, 64)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    perm = rng.permutation(32)
    fa = make_features(d)
    fb = make_features(d[perm])
    m = match_features(fa, fb, MatchConfig(max_matches=64, ratio=0.9))
    v = np.asarray(m.valid)
    assert v.sum() == 32
    ia = np.asarray(m.idx_a)[v]
    ib = np.asarray(m.idx_b)[v]
    assert (perm[ib] == ia).all()


def test_match_respects_validity(rng):
    d = rng.standard_normal((16, 64)).astype(np.float32)
    valid_b = np.ones(16, bool)
    valid_b[8:] = False
    fa = make_features(d)
    fb = make_features(d, valid_b)
    m = match_features(fa, fb, MatchConfig(max_matches=32, ratio=0.95))
    v = np.asarray(m.valid)
    assert np.all(np.asarray(m.idx_b)[v] < 8)


def test_ratio_test_rejects_ambiguous():
    """Two comparably-near candidates in B -> ratio test kills the match.
    Uses well-separated unit vectors so float32 |a|^2+|b|^2-2ab is exact:
    dist(a,b0)^2 = 1.0, dist(a,b1)^2 = 1.21, ratio 0.91 > 0.8."""
    d_a = np.zeros((1, 64), np.float32)
    d_a[0, 0] = 1.0
    d_b = np.zeros((2, 64), np.float32)
    d_b[0, 0] = 1.0
    d_b[0, 1] = 1.0    # dist^2 = 1.0
    d_b[1, 0] = 1.0
    d_b[1, 2] = 1.1    # dist^2 = 1.21
    fa = make_features(d_a)
    fb = make_features(d_b)
    m = match_features(fa, fb, MatchConfig(ratio=0.8, max_matches=8))
    assert int(m.count()) == 0
    # sanity: with a permissive ratio the best match IS found
    m2 = match_features(fa, fb, MatchConfig(ratio=0.95, max_matches=8))
    assert int(m2.count()) == 1


def test_match_two_nn_semantics_vs_bruteforce(rng):
    """The matcher's best/second-best/nn come from three reduction passes
    (min, argmin, masked second-min) rather than a per-row top-k sort.
    This pins the reduction-pass formulation to exact brute-force 2-NN
    semantics."""
    a = rng.standard_normal((96, 32)).astype(np.float32)
    b = rng.standard_normal((96, 32)).astype(np.float32)
    valid_a = rng.random(96) > 0.2
    valid_b = rng.random(96) > 0.2
    cfg = MatchConfig(max_matches=96, ratio=0.95, mutual=True)
    m = match_features(make_features(a, valid_a),
                       make_features(b, valid_b), cfg)

    d = ((a[:, None] - b[None]) ** 2).sum(-1)
    d[~valid_a] = np.inf
    d[:, ~valid_b] = np.inf
    nn = d.argmin(1)
    part = np.sort(d, axis=1)
    ratio_ok = part[:, 0] < cfg.ratio ** 2 * part[:, 1]
    col_nn = d.argmin(0)
    mutual_ok = col_nn[nn] == np.arange(96)
    want = valid_a & np.isfinite(part[:, 0]) & ratio_ok & mutual_ok

    got_pairs = {(int(ia), int(ib))
                 for ia, ib, v in zip(np.asarray(m.idx_a),
                                      np.asarray(m.idx_b),
                                      np.asarray(m.valid)) if v}
    want_pairs = {(int(i), int(nn[i])) for i in np.nonzero(want)[0]}
    assert got_pairs == want_pairs


@pytest.mark.parametrize("ka,kb,dim", [(37, 53, 128), (130, 61, 128),
                                       (255, 257, 64)])
def test_match_2nn_odd_sizes_vs_bruteforce(rng, ka, kb, dim):
    """Ratio + mutual 2-NN matching against brute force at capacities that
    line up with no tile size, unit-norm descriptors as SIFT emits them."""
    a = rng.standard_normal((ka, dim)).astype(np.float32)
    b = rng.standard_normal((kb, dim)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    b[: kb // 2] = a[rng.permutation(ka)[: kb // 2]] + 0.01 * \
        rng.standard_normal((kb // 2, dim)).astype(np.float32)
    valid_a = rng.random(ka) > 0.1
    valid_b = rng.random(kb) > 0.1
    cfg = MatchConfig(max_matches=ka, ratio=0.8, mutual=True)
    m = match_features(make_features(a, valid_a),
                       make_features(b, valid_b), cfg)

    d = ((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1)
    d[~valid_a] = np.inf
    d[:, ~valid_b] = np.inf
    nn = d.argmin(1)
    part = np.sort(d, axis=1)
    want = (valid_a & np.isfinite(part[:, 0])
            & (part[:, 0] < cfg.ratio ** 2 * part[:, 1])
            & (d.argmin(0)[nn] == np.arange(ka)))
    got = {(int(i), int(j)) for i, j, v in zip(
        np.asarray(m.idx_a), np.asarray(m.idx_b), np.asarray(m.valid)) if v}
    assert got == {(int(i), int(nn[i])) for i in np.nonzero(want)[0]}
    assert len(got) > kb // 4
    # best first
    dist = np.asarray(m.distance)[np.asarray(m.valid)]
    assert np.all(np.diff(dist) >= 0)
