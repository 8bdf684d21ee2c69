"""Utility tests: config serialization, masked-set ops, debug helpers."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from visualslam.utils.config import (
    DEFAULT_CONFIG,
    FAST_CONFIG,
    PyramidConfig,
    SlamConfig,
)
from visualslam.utils.masked import (
    block_top_k_select,
    compact,
    merge,
    top_k_select,
)


def test_config_roundtrip_json():
    cfg = DEFAULT_CONFIG.replace(frontend="orb")
    s = cfg.to_json()
    back = SlamConfig.from_json(s)
    assert back == cfg
    assert back.to_json() == s


def test_config_hashable_static_arg():
    """Configs must be usable as jit static arguments."""
    calls = []

    @jax.jit
    def f(x):
        return x

    def g(x, cfg):
        calls.append(cfg)
        return x * cfg.pyramid.base_sigma

    jg = jax.jit(g, static_argnums=1)
    jg(jnp.ones(3), DEFAULT_CONFIG)
    jg(jnp.ones(3), FAST_CONFIG)
    assert hash(DEFAULT_CONFIG) != hash(FAST_CONFIG)
    assert DEFAULT_CONFIG.replace() == DEFAULT_CONFIG


def test_config_rejects_unknown_keys():
    with pytest.raises(KeyError):
        PyramidConfig.from_dict({"bogus_key": 1})


def test_top_k_select_padding():
    scores = jnp.asarray([3.0, 1.0, 2.0])
    valid = jnp.asarray([True, False, True])
    idx, mask = top_k_select(scores, valid, 5)
    assert idx.shape == (5,)
    assert list(np.asarray(mask)) == [True, True, False, False, False]
    assert list(np.asarray(idx)[:2]) == [0, 2]


def test_block_top_k_matches_exact_on_sparse(rng):
    """With sparse candidates (less than one per block) block top-k equals
    exact top-k."""
    n, k = 1 << 16, 32
    scores = jnp.asarray(rng.random(n, dtype=np.float32))
    valid = np.zeros(n, bool)
    chosen = rng.choice(n // 256, 50, replace=False) * 256 + 7
    valid[chosen] = True
    i1, m1 = top_k_select(scores, jnp.asarray(valid), k)
    i2, m2 = block_top_k_select(scores, jnp.asarray(valid), k, block=128)
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
    np.testing.assert_array_equal(np.sort(np.asarray(i1)[np.asarray(m1)]),
                                  np.sort(np.asarray(i2)[np.asarray(m2)]))


def test_compact_stable():
    mask = jnp.asarray([False, True, False, True, True])
    vals = jnp.asarray([0.0, 1.0, 2.0, 3.0, 4.0])
    new_mask, out = compact(mask, vals)
    assert list(np.asarray(new_mask)) == [True, True, True, False, False]
    assert list(np.asarray(out)[:3]) == [1.0, 3.0, 4.0]


def test_merge_keeps_best():
    sa = jnp.asarray([5.0, 1.0])
    sb = jnp.asarray([3.0, 4.0])
    ma = jnp.asarray([True, True])
    mb = jnp.asarray([True, False])
    va = jnp.asarray([10, 11])
    vb = jnp.asarray([20, 21])
    scores, mask, vals = merge(sa, ma, sb, mb, 3, va, vb)
    assert list(np.asarray(scores)) == [5.0, 3.0, 1.0]
    assert list(np.asarray(vals)) == [10, 20, 11]


def test_debug_checked_catches_nan():
    from visualslam.utils.debug import checked

    def bad(x):
        return jnp.log(x)  # nan for negative input

    err, out = checked(jax.jit(bad))(jnp.asarray(-1.0))
    with pytest.raises(Exception):
        err.throw()


def test_stage_timer():
    from visualslam.utils.profiling import StageTimer

    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2
