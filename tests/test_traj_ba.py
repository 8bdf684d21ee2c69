"""Trajectory-sharded BA (parallel/traj_ba.py) on the 8-virtual-device CPU
mesh: camera blocks sharded, covisibility-partitioned landmarks, ppermute
ring reduce-scatter of the Schur rows, distributed CG solve. Must reach the
same optimum as the single-device solver."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from visualslam.backend.ba import run_ba_jit
from visualslam.parallel.collectives import (
    ring_all_gather,
    ring_reduce_scatter,
)
from visualslam.parallel.mesh import make_mesh
from visualslam.parallel.traj_ba import (
    run_ba_traj_sharded,
    shard_problem_trajectory,
    unshard_traj,
)
from visualslam.utils.config import BAConfig

from test_ba import make_ba_problem


def test_ring_reduce_scatter_and_gather(rng):
    mesh = make_mesh(8, axis="r")
    x = rng.standard_normal((8, 8, 5)).astype(np.float32)  # [dev, chunk, d]

    def f(v):
        v = v[0]                       # [8, 5] full copy w/ partial values
        rs = ring_reduce_scatter(v, "r")          # [5] own chunk summed
        ag = ring_all_gather(rs, "r")             # [8, 5] all chunks
        return rs[None], ag[None]

    rs, ag = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=P("r"), out_specs=(P("r"), P("r"))))(
        jnp.asarray(x))
    want = x.sum(0)                    # [8, 5]
    np.testing.assert_allclose(np.asarray(rs), want, atol=1e-5)
    for d in range(8):
        np.testing.assert_allclose(np.asarray(ag)[d], want, atol=1e-5)


def test_traj_shard_roundtrip(rng):
    p, *_ = make_ba_problem(rng, n_cams=8, n_lms=160)
    sp = shard_problem_trajectory(p, 8)
    assert sp.R.shape == (8, 1, 3, 3)
    assert int(np.asarray(sp.obs_valid).sum()) == int(
        np.asarray(p.obs_valid).sum())
    R, t, X = unshard_traj(sp.R, sp.t, sp.X, sp.lm_order, 160)
    np.testing.assert_allclose(R, np.asarray(p.R))
    np.testing.assert_allclose(t, np.asarray(p.t))
    np.testing.assert_allclose(X, np.asarray(p.X))


def test_traj_partition_is_covisibility_aware(rng):
    """A landmark observed only by cameras of one shard must live there."""
    p, *_ = make_ba_problem(rng, n_cams=8, n_lms=160, drop=0.0)
    # restrict each landmark's observations to one camera pair (3, 4)?
    # simpler: take the real problem and check the majority property on a
    # sample: every landmark's shard owns >= as many of its observations as
    # any other shard (up to capacity spill)
    sp = shard_problem_trajectory(p, 4)
    cam = np.asarray(p.cam_idx)
    lm = np.asarray(p.lm_idx)
    shard_of_cam = cam // 2
    votes = np.zeros((160, 4), np.int64)
    np.add.at(votes, (lm, shard_of_cam), 1)
    # landmark slot -> shard
    lo = sp.lm_order
    Ls = len(lo) // 4
    spilled = 0
    for slot, li in enumerate(lo):
        if li < 0:
            continue
        s = slot // Ls
        if votes[li, s] < votes[li].max():
            spilled += 1
    assert spilled <= 0.3 * 160    # most landmarks sit with their majority


def test_traj_sharded_matches_single(rng):
    p, R_gt, t_gt, X_gt = make_ba_problem(rng, n_cams=8, n_lms=320)
    cfg = BAConfig(iters=8, cg_iters=64, max_cameras=8)

    single = run_ba_jit(p, cfg)
    mesh = make_mesh(8, axis="shard")
    sp = shard_problem_trajectory(p, 8)
    dist = run_ba_traj_sharded(sp, cfg, mesh)

    np.testing.assert_allclose(float(dist.initial_cost),
                               float(single.initial_cost), rtol=1e-5)
    assert float(dist.cost) < float(dist.initial_cost) * 1e-3
    R, t, X = unshard_traj(dist.R, dist.t, dist.X, sp.lm_order, 320)
    np.testing.assert_allclose(R, np.asarray(single.R), atol=5e-4)
    np.testing.assert_allclose(t, np.asarray(single.t), atol=5e-3)
    np.testing.assert_allclose(X, np.asarray(single.X), atol=2e-2)
    for c in range(8):
        cos = (np.trace(R[c].T @ R_gt[c]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.1


def test_traj_sharded_multi_camera_blocks(rng):
    """Cs > 1 (8 cameras over 4 shards)."""
    p, *_ = make_ba_problem(rng, n_cams=8, n_lms=160)
    cfg = BAConfig(iters=6, cg_iters=64, max_cameras=8)
    single = run_ba_jit(p, cfg)
    mesh = make_mesh(4, axis="shard")
    sp = shard_problem_trajectory(p, 4)
    dist = run_ba_traj_sharded(sp, cfg, mesh)
    R, t, X = unshard_traj(dist.R, dist.t, dist.X, sp.lm_order, 160)
    np.testing.assert_allclose(R, np.asarray(single.R), atol=1e-3)
    np.testing.assert_allclose(t, np.asarray(single.t), atol=1e-2)


def test_traj_sharded_matrix_free_matches_single(rng):
    """solver="schur_mf": the distributed step materializes neither the
    coupling nor Schur rows (one [C,6] psum per CG matvec) and must reach
    the same optimum as the single-device dense solver."""
    p, R_gt, t_gt, X_gt = make_ba_problem(rng, n_cams=8, n_lms=320)
    cfg = BAConfig(iters=8, cg_iters=64, max_cameras=8, solver="schur_mf")

    single = run_ba_jit(p, cfg.replace(solver="schur_dense"))
    mesh = make_mesh(8, axis="shard")
    sp = shard_problem_trajectory(p, 8)
    dist = run_ba_traj_sharded(sp, cfg, mesh)

    np.testing.assert_allclose(float(dist.initial_cost),
                               float(single.initial_cost), rtol=1e-5)
    assert float(dist.cost) < float(dist.initial_cost) * 1e-3
    R, t, X = unshard_traj(dist.R, dist.t, dist.X, sp.lm_order, 320)
    np.testing.assert_allclose(R, np.asarray(single.R), atol=5e-4)
    np.testing.assert_allclose(t, np.asarray(single.t), atol=5e-3)
    np.testing.assert_allclose(X, np.asarray(single.X), atol=2e-2)
