"""Sharded matching (parallel/dist_match.py) on the 8-virtual-CPU mesh:
the blockwise 2-NN over a sharded B side must equal the single-device
full-matrix result."""

import numpy as np

import jax.numpy as jnp

from visualslam.parallel.dist_match import shard_descriptors, sharded_2nn
from visualslam.parallel.mesh import make_mesh


def _full_2nn(qa, kb, vb):
    d = ((qa ** 2).sum(1)[:, None] + (kb ** 2).sum(1)[None, :]
         - 2 * qa @ kb.T)
    d = np.maximum(d, 0)
    d[:, ~vb] = 1e30
    order = np.argsort(d, axis=1)
    best = d[np.arange(len(qa)), order[:, 0]]
    second = d[np.arange(len(qa)), order[:, 1]]
    return best, second, order[:, 0]


def test_sharded_2nn_matches_full(rng):
    Ka, Kb, D = 96, 1000, 64
    qa = rng.standard_normal((Ka, D)).astype(np.float32)
    kb = rng.standard_normal((Kb, D)).astype(np.float32)
    vb = rng.random(Kb) > 0.1
    mesh = make_mesh(8, axis="shard")
    kb_s, vb_s = shard_descriptors(kb, vb, 8)
    best, second, idx = sharded_2nn(jnp.asarray(qa), kb_s, vb_s, mesh)

    want_b, want_s, want_i = _full_2nn(qa, kb, vb)
    np.testing.assert_allclose(np.asarray(best), want_b, rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(second), want_s, rtol=2e-4,
                               atol=1e-4)
    # index agreement except at numerical near-ties
    close = np.abs(want_s - want_b) < 1e-4
    agree = np.asarray(idx) == want_i
    assert (agree | close).mean() > 0.99


def test_sharded_2nn_all_invalid_shard(rng):
    """A shard with zero valid descriptors must not poison the result."""
    Ka, Kb, D = 32, 64, 16
    qa = rng.standard_normal((Ka, D)).astype(np.float32)
    kb = rng.standard_normal((Kb, D)).astype(np.float32)
    vb = np.ones(Kb, bool)
    vb[:16] = False            # shards 0-1 fully invalid (Kb_s = 8)
    mesh = make_mesh(8, axis="shard")
    kb_s, vb_s = shard_descriptors(kb, vb, 8)
    best, second, idx = sharded_2nn(jnp.asarray(qa), kb_s, vb_s, mesh)
    want_b, _, want_i = _full_2nn(qa, kb, vb)
    np.testing.assert_allclose(np.asarray(best), want_b, rtol=2e-4,
                               atol=1e-4)
    assert (np.asarray(idx) >= 16).all()
