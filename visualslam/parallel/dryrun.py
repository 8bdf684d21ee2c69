"""Multi-chip dry run: compile + execute the distributed pipeline on an
n-device mesh with tiny shapes (driven by __graft_entry__.dryrun_multichip).

Exercises the distributed paths of a full SEQUENCE step on the same mesh:
  1. data-parallel SIFT frontend (shard_map over 'data' axis + psum),
  2. the fused per-frame tracking program (slam/track_step.py) — the
     engine's forward step,
  3. the landmark-sharded Schur BA (psum'd reduced camera system), and
  4. the TRAJECTORY-sharded BA over a multi-keyframe window (camera blocks
     per device, ppermute ring Schur reduce-scatter, distributed CG —
     parallel/traj_ba.py), i.e. the full-sequence "training step".
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from visualslam.frontend import detect_and_describe
from visualslam.parallel.mesh import make_mesh
from visualslam.utils.config import DEFAULT_CONFIG, BAConfig


def _dryrun_frontend(n_devices: int) -> None:
    mesh = make_mesh(n_devices, axis="data")
    cfg = DEFAULT_CONFIG.replace(image_height=64, image_width=96)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.random((n_devices, 64, 96), dtype=np.float32))

    def step(batch):
        feats = jax.vmap(lambda im: detect_and_describe(im, cfg))(batch)
        total = jax.lax.psum(
            jnp.sum(feats.keypoints.valid.astype(jnp.int32)), "data")
        return feats.descriptors, total

    smapped = jax.shard_map(step, mesh=mesh, in_specs=P("data"),
                            out_specs=(P("data"), P()))
    desc, total = jax.jit(smapped)(imgs)
    jax.block_until_ready((desc, total))
    assert desc.shape[0] == n_devices
    print(f"[dryrun] frontend mesh={dict(mesh.shape)} "
          f"total_detections={int(total)}")


def _dryrun_ba(n_devices: int) -> None:
    from visualslam.backend.ba import BAProblem
    from visualslam.geometry import se3
    from visualslam.parallel.dist_ba import run_ba_sharded, shard_problem

    rng = np.random.default_rng(1)
    C, L = 4, 16 * n_devices
    X = rng.uniform([-2, -2, 5], [2, 2, 9], (L, 3))
    R = np.stack([np.asarray(se3.exp_so3(jnp.asarray(
        [0.0, 0.02 * c, 0.0]))) for c in range(C)])
    t = np.stack([np.array([-0.3 * c, 0.0, 0.0]) for c in range(C)])
    cam_idx = np.tile(np.arange(C), L)
    lm_idx = np.repeat(np.arange(L), C)
    Xc = np.einsum("oij,oj->oi", R[cam_idx], X[lm_idx]) + t[cam_idx]
    uv = Xc[:, :2] / Xc[:, 2:]
    p = BAProblem(
        R=jnp.asarray(R, jnp.float32), t=jnp.asarray(t, jnp.float32),
        X=jnp.asarray(X + rng.normal(0, 0.05, X.shape), jnp.float32),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        lm_idx=jnp.asarray(lm_idx, jnp.int32),
        uv=jnp.asarray(uv, jnp.float32),
        obs_valid=jnp.ones(len(cam_idx), bool),
        cam_valid=jnp.ones(C, bool), lm_valid=jnp.ones(L, bool),
    )
    mesh = make_mesh(n_devices, axis="shard")
    res = run_ba_sharded(shard_problem(p, n_devices), BAConfig(iters=3),
                         mesh)
    jax.block_until_ready(res)
    print(f"[dryrun] sharded BA mesh={dict(mesh.shape)} "
          f"cost {float(res.initial_cost):.3e} -> {float(res.cost):.3e}")
    assert float(res.cost) < float(res.initial_cost)


def _dryrun_track_step(n_devices: int) -> None:
    """Compile + run the fused per-frame tracking program on tiny shapes
    (the sequence step between frontend and backend)."""
    from visualslam.models.types import Features, Keypoints
    from visualslam.slam.track_step import (
        KeyframeRef, LocalMap, TrackState, track_step)

    cfg = DEFAULT_CONFIG.replace(
        sift=DEFAULT_CONFIG.sift.replace(max_keypoints=64),
        match=DEFAULT_CONFIG.match.replace(max_matches=32),
        local_map_size=64)
    rng = np.random.default_rng(2)
    K, D, Kl = 64, 128, 64

    def feats(seed):
        r = np.random.default_rng(seed)
        kps = Keypoints.empty(K)._replace(
            yx=jnp.asarray(r.uniform(0, 60, (K, 2)).astype(np.float32)),
            valid=jnp.ones(K, bool))
        return Features(kps, jnp.asarray(
            r.standard_normal((K, D)).astype(np.float32)))

    kf = KeyframeRef(desc=feats(0).descriptors, yx=feats(0).keypoints.yx,
                     kp_valid=jnp.ones(K, bool),
                     kp_has_lm=jnp.zeros(K, bool),
                     R=jnp.eye(3), t=jnp.zeros(3))
    lmap = LocalMap(desc=feats(1).descriptors,
                    X=jnp.asarray(rng.uniform(-2, 2, (Kl, 3)),
                                  jnp.float32),
                    valid=jnp.ones(Kl, bool))
    state = TrackState(R=jnp.eye(3), t=jnp.zeros(3),
                       vel=jnp.zeros(6))
    intr = jnp.asarray([60.0, 60.0, 30.0, 30.0])
    step = jax.jit(lambda kf, lm, f, s: track_step(
        kf, lm, f, s, intr, cfg, 10, 100.0))
    out = step(kf, lmap, feats(2), state)
    jax.block_until_ready(out.stats)
    print(f"[dryrun] fused track_step OK (stats[:4]="
          f"{np.asarray(out.stats[:4]).round(2).tolist()})")


def _dryrun_traj_ba(n_devices: int) -> None:
    """Trajectory-sharded window BA: Cs cameras per device, covisibility
    landmark partition, ring reduce-scatter Schur assembly, distributed
    CG solve."""
    from visualslam.backend.ba import BAProblem
    from visualslam.geometry import se3
    from visualslam.parallel.traj_ba import (
        run_ba_traj_sharded, shard_problem_trajectory, unshard_traj)

    rng = np.random.default_rng(3)
    C, L = 2 * n_devices, 8 * n_devices      # multi-keyframe window
    X = rng.uniform([-2, -2, 5], [2, 2, 9], (L, 3))
    R = np.stack([np.asarray(se3.exp_so3(jnp.asarray(
        [0.0, 0.01 * c, 0.0]))) for c in range(C)])
    t = np.stack([np.array([-0.2 * c, 0.0, 0.0]) for c in range(C)])
    cam_idx = np.tile(np.arange(C), L)
    lm_idx = np.repeat(np.arange(L), C)
    Xc = np.einsum("oij,oj->oi", R[cam_idx], X[lm_idx]) + t[cam_idx]
    uv = Xc[:, :2] / Xc[:, 2:]
    p = BAProblem(
        R=jnp.asarray(R, jnp.float32), t=jnp.asarray(t, jnp.float32),
        X=jnp.asarray(X + rng.normal(0, 0.03, X.shape), jnp.float32),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        lm_idx=jnp.asarray(lm_idx, jnp.int32),
        uv=jnp.asarray(uv, jnp.float32),
        obs_valid=jnp.ones(len(cam_idx), bool),
        cam_valid=jnp.ones(C, bool), lm_valid=jnp.ones(L, bool),
    )
    mesh = make_mesh(n_devices, axis="shard")
    sp = shard_problem_trajectory(p, n_devices)
    from visualslam.utils.config import BAConfig

    res = run_ba_traj_sharded(sp, BAConfig(iters=3, cg_iters=32), mesh)
    jax.block_until_ready(res)
    print(f"[dryrun] traj-sharded BA mesh={dict(mesh.shape)} "
          f"C={C} (x{n_devices} blocks) cost "
          f"{float(res.initial_cost):.3e} -> {float(res.cost):.3e}")
    assert float(res.cost) < float(res.initial_cost)


def _dryrun_traj_ba_mf(n_devices: int) -> None:
    """Full-sequence-scale trajectory-sharded BA with the MATRIX-FREE
    distributed solver: C=1024 cameras over the mesh, 4096 landmarks,
    16k observations. The dense path would materialize [Cs,6,C,6] Schur
    rows (151 MB/shard at this C); schur_mf's per-CG-matvec communication
    is one [C,6] psum."""
    from visualslam.backend.ba import BAProblem
    from visualslam.parallel.traj_ba import (
        run_ba_traj_sharded, shard_problem_trajectory)
    from visualslam.utils.config import BAConfig

    rng = np.random.default_rng(4)
    C, L, per = 1024, 4096, 4
    ks = np.arange(C)
    yaw = 0.002 * ks
    cw = np.stack([0.05 * ks, np.zeros(C), 0.4 * ks], -1)
    R = np.stack([[[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]] for a in yaw])
    t = -np.einsum("cij,cj->ci", R, cw)
    anchor = (np.arange(L) / L * C * 0.4).astype(np.float32)
    X = np.stack([rng.uniform(-20, 20, L), rng.uniform(-10, 10, L),
                  anchor + rng.uniform(8, 40, L)], -1)
    base_cam = np.clip((anchor / 0.4).astype(np.int64), 0, C - 1 - per)
    cam_idx = (base_cam[:, None] + np.arange(per)[None]).reshape(-1)
    lm_idx = np.repeat(np.arange(L), per)
    Xc = np.einsum("oij,oj->oi", R[cam_idx], X[lm_idx]) + t[cam_idx]
    z = np.maximum(Xc[:, 2], 1e-3)
    uv = Xc[:, :2] / z[:, None]
    valid = (Xc[:, 2] > 1.0) & (np.abs(uv) < 1.5).all(1)
    p = BAProblem(
        R=jnp.asarray(R, jnp.float32), t=jnp.asarray(t, jnp.float32),
        X=jnp.asarray(X + rng.normal(0, 0.1, X.shape), jnp.float32),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        lm_idx=jnp.asarray(lm_idx, jnp.int32),
        uv=jnp.asarray(uv, jnp.float32),
        obs_valid=jnp.asarray(valid),
        cam_valid=jnp.ones(C, bool), lm_valid=jnp.ones(L, bool),
    )
    mesh = make_mesh(n_devices, axis="shard")
    sp = shard_problem_trajectory(p, n_devices)
    res = run_ba_traj_sharded(
        sp, BAConfig(iters=2, cg_iters=24, solver="schur_mf"), mesh)
    jax.block_until_ready(res)
    print(f"[dryrun] traj-sharded MATRIX-FREE BA mesh={dict(mesh.shape)} "
          f"C={C} L={L} cost "
          f"{float(res.initial_cost):.3e} -> {float(res.cost):.3e}")
    assert float(res.cost) < float(res.initial_cost)


def run_dryrun(n_devices: int) -> None:
    _dryrun_frontend(n_devices)
    _dryrun_track_step(n_devices)
    _dryrun_ba(n_devices)
    _dryrun_traj_ba(n_devices)
    _dryrun_traj_ba_mf(n_devices)
