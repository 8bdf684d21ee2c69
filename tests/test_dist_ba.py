"""Distributed BA on the 8-virtual-device CPU mesh: the sharded solver must
match the single-device solver (SURVEY.md §4 implication (4))."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from visualslam.backend.ba import run_ba_jit
from visualslam.parallel.dist_ba import (
    run_ba_sharded,
    shard_problem,
    unshard_points,
)
from visualslam.parallel.mesh import make_mesh
from visualslam.utils.config import BAConfig

from test_ba import make_ba_problem


def test_sharded_matches_single(rng):
    p, R_gt, t_gt, X_gt = make_ba_problem(rng, n_cams=5, n_lms=320)
    cfg = BAConfig(iters=8)

    single = run_ba_jit(p, cfg)

    mesh = make_mesh(8, axis="shard")
    sp = shard_problem(p, 8)
    dist = run_ba_sharded(sp, cfg, mesh)

    assert float(dist.cost) < float(dist.initial_cost) * 1e-3
    np.testing.assert_allclose(float(dist.initial_cost),
                               float(single.initial_cost), rtol=1e-5)
    # same optimum (fp reduction order differs -> loose-ish tolerances)
    np.testing.assert_allclose(np.asarray(dist.R), np.asarray(single.R),
                               atol=5e-4)
    np.testing.assert_allclose(np.asarray(dist.t), np.asarray(single.t),
                               atol=5e-3)
    X_d = np.asarray(unshard_points(dist.X, sp.lm_order))
    np.testing.assert_allclose(X_d, np.asarray(single.X), atol=2e-2)
    # and near ground truth
    for c in range(5):
        Rr = np.asarray(dist.R[c])
        cos = (np.trace(Rr.T @ R_gt[c]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.1


def test_shard_problem_roundtrip(rng):
    p, *_ = make_ba_problem(rng, n_cams=4, n_lms=160)
    sp = shard_problem(p, 8)
    assert sp.X.shape == (8, 20, 3)
    # every valid original observation appears exactly once
    total = int(np.asarray(sp.obs_valid).sum())
    assert total == int(np.asarray(p.obs_valid).sum())
    # local lm_idx within range
    li = np.asarray(sp.lm_idx)
    assert li.min() >= 0 and li.max() < 20
    # packing permutation restores the original landmark order
    X_rt = np.asarray(unshard_points(sp.X, sp.lm_order))
    np.testing.assert_allclose(X_rt, np.asarray(p.X))


def test_balanced_partition_shrinks_padding(rng):
    """Skewed observation counts: the block partition pays max-shard
    padding; the balanced (LPT) partition equalizes per-shard loads."""
    import jax.numpy as jnp
    from visualslam.backend.ba import BAProblem

    n_cams, L, n_shards = 4, 64, 8
    # landmark k gets k%8==0 -> 16 observations, else 1 (heavy head, and the
    # heavy landmarks all fall in the SAME index block)
    cam_idx, lm_idx = [], []
    for k in range(L):
        reps = 16 if k < 8 else 1
        for r in range(reps):
            cam_idx.append(r % n_cams)
            lm_idx.append(k)
    O = len(lm_idx)
    p = BAProblem(
        R=jnp.tile(jnp.eye(3, dtype=jnp.float32), (n_cams, 1, 1)),
        t=jnp.zeros((n_cams, 3), jnp.float32),
        X=jnp.asarray(rng.normal(0, 1, (L, 3)).astype(np.float32)),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        lm_idx=jnp.asarray(lm_idx, jnp.int32),
        uv=jnp.zeros((O, 2), jnp.float32),
        obs_valid=jnp.ones(O, bool),
        cam_valid=jnp.ones(n_cams, bool),
        lm_valid=jnp.ones(L, bool))

    sp_block = shard_problem(p, n_shards, partition="block")
    sp_bal = shard_problem(p, n_shards, partition="balanced")
    # block: shard 0 holds all 8 heavy landmarks -> O_s = 8*16 + 0
    # balanced: one heavy landmark per shard -> O_s = 16 + 7
    assert sp_block.obs_valid.shape[1] == 8 * 16
    assert sp_bal.obs_valid.shape[1] == 16 + 7
    # same total work, same observations
    assert (int(np.asarray(sp_bal.obs_valid).sum())
            == int(np.asarray(sp_block.obs_valid).sum()) == O)


def test_balanced_matches_block_result(rng):
    p, *_ = make_ba_problem(rng, n_cams=5, n_lms=320)
    cfg = BAConfig(iters=6)
    mesh = make_mesh(8, axis="shard")
    r_block = run_ba_sharded(shard_problem(p, 8, partition="block"),
                             cfg, mesh)
    r_bal = run_ba_sharded(shard_problem(p, 8, partition="balanced"),
                           cfg, mesh)
    np.testing.assert_allclose(np.asarray(r_block.R), np.asarray(r_bal.R),
                               atol=5e-4)
    np.testing.assert_allclose(float(r_block.cost), float(r_bal.cost),
                               rtol=1e-3, atol=1e-10)


def test_ring_allreduce_matches_psum(rng):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from visualslam.parallel.collectives import ring_allreduce
    from visualslam.parallel.mesh import make_mesh

    mesh = make_mesh(8, axis="r")
    x = rng.standard_normal((8, 37)).astype(np.float32)

    def f(v):
        v = v[0]
        return (ring_allreduce(v, "r")[None],
                jax.lax.psum(v, "r")[None])

    ring, ps = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=P("r"), out_specs=(P("r"), P("r"))))(
        jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(ring), np.asarray(ps), atol=1e-4)
    np.testing.assert_allclose(np.asarray(ring)[0], x.sum(0), atol=1e-4)


def test_sharded_ba_ring_reduce(rng):
    p, *_ = make_ba_problem(rng, n_cams=4, n_lms=160)
    cfg = BAConfig(iters=5)
    mesh = make_mesh(8, axis="shard")
    sp = shard_problem(p, 8)
    r_psum = run_ba_sharded(sp, cfg, mesh, reduce="psum")
    r_ring = run_ba_sharded(sp, cfg, mesh, reduce="ring")
    np.testing.assert_allclose(np.asarray(r_ring.R), np.asarray(r_psum.R),
                               atol=1e-4)
    assert float(r_ring.cost) < float(r_ring.initial_cost) * 1e-2


@pytest.mark.parametrize("layout", ["landmark", "trajectory"])
def test_sharded_ba_lowers_matmuls_in_float32(rng, monkeypatch, layout):
    """Both sharded solvers trace their matmuls at HIGHEST precision, as
    the single-device solver does: at DEFAULT a GPU runs them in TF32,
    which left the landmark-sharded solve at a worse optimum on an H100."""
    from visualslam.parallel.traj_ba import (run_ba_traj_sharded,
                                             shard_problem_trajectory)

    texts = []
    real_jit = jax.jit

    def spy(fn, *a, **kw):
        compiled = real_jit(fn, *a, **kw)

        def call(*args):
            texts.append(compiled.lower(*args).as_text())
            return compiled(*args)
        return call

    p, *_ = make_ba_problem(rng, n_cams=4, n_lms=64)
    cfg = BAConfig(iters=1)
    mesh = make_mesh(4, axis="shard")
    monkeypatch.setattr(jax, "jit", spy)
    if layout == "landmark":
        run_ba_sharded(shard_problem(p, 4), cfg, mesh)
    else:
        run_ba_traj_sharded(shard_problem_trajectory(p, 4), cfg, mesh)
    hlo = "\n".join(texts)
    assert "dot_general" in hlo
    assert "precision = [DEFAULT" not in hlo
