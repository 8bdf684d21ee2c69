"""Full-sequence (global) bundle adjustment over the ENTIRE keyframe
history — the distributed "full sequence" configuration of BASELINE
configs[4] that the sliding window alone cannot provide.

The SlamMap archives every evicted keyframe (pose + uid-keyed observations,
map_state.ArchivedKeyframe) and snapshots landmark positions when slots are
recycled, so after a run the complete observation graph is recoverable:

    cameras    = archived keyframes + live window keyframes
    landmarks  = every uid observed by >= 2 of those cameras
    obs        = uid-validated normalized-plane measurements

The problem is handed to backend/ba.run_ba on one chip, or to
parallel/traj_ba.run_ba_traj_sharded on a device mesh: contiguous
trajectory blocks of keyframes per device, covisibility-partitioned
landmarks, ppermute ring Schur reduction, distributed CG — the sequence
axis is what scales across chips, exactly the long-context analogue of
SURVEY.md §5.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

from visualslam.backend.ba import BAProblem, run_ba_jit
from visualslam.utils.config import BAConfig


class GlobalBAResult(NamedTuple):
    frame_ids: np.ndarray   # [K] keyframe frame ids
    R: np.ndarray           # [K, 3, 3] optimized world-to-camera
    t: np.ndarray           # [K, 3]
    cost: float
    initial_cost: float
    n_cameras: int
    n_landmarks: int
    n_observations: int


def _collect(slam_map, corrected: Optional[dict] = None):
    """Flatten archive + live window into (frame_ids, R, t, per-kf
    (uid, uv) lists). `corrected`: optional frame_id -> (R, t) overrides
    (loop-closure-corrected poses)."""
    kfs = []
    for a in slam_map.archive:
        kfs.append((a.frame_id, a.R, a.t, a.lm_uid, a.uv))
    for s in slam_map.kf_order:
        if not slam_map.kf_valid[s]:
            continue
        if s in slam_map.obs:
            lm_idx, lm_uid, uv = slam_map.obs[s]
            live = (slam_map.lm_valid[lm_idx]
                    & (slam_map.lm_uid[lm_idx] == lm_uid))
            uid, uv = lm_uid[live], uv[live]
        else:
            uid = np.zeros(0, np.int64)
            uv = np.zeros((0, 2), np.float32)
        kfs.append((int(slam_map.kf_frame_id[s]), slam_map.kf_R[s].copy(),
                    slam_map.kf_t[s].copy(), uid, uv))
    kfs.sort(key=lambda e: e[0])
    if corrected:
        kfs = [(fid, *(corrected.get(fid, (R, t))), uid, uv)
               for fid, R, t, uid, uv in kfs]
    return kfs


def _landmark_positions(slam_map) -> dict:
    pos = dict(slam_map.archived_lm_pos)
    live = np.nonzero(slam_map.lm_valid)[0]
    for s in live:
        pos[int(slam_map.lm_uid[s])] = slam_map.X[s]
    return pos


def build_global_problem(slam_map, corrected: Optional[dict] = None,
                         min_obs: int = 2,
                         pad_cameras_to: int = 1):
    """Returns (BAProblem, frame_ids [K]) over the full history.

    Capacities are the exact problem size rounded up (cameras to a multiple
    of `pad_cameras_to` for trajectory sharding)."""
    kfs = _collect(slam_map, corrected)
    K = len(kfs)
    if K < 2:
        raise ValueError("global BA needs at least 2 keyframes")

    # landmark set: uids observed by >= min_obs keyframes with a known pos
    counts: dict[int, int] = {}
    for _, _, _, uid, _ in kfs:
        for u in np.unique(uid):
            counts[int(u)] = counts.get(int(u), 0) + 1
    pos = _landmark_positions(slam_map)
    uids = sorted(u for u, c in counts.items() if c >= min_obs and u in pos)
    uid_to_l = {u: i for i, u in enumerate(uids)}
    L = len(uids)
    if L < 8:
        raise ValueError(f"global BA: only {L} multi-view landmarks")

    cams, lms, uvs = [], [], []
    for c, (_, _, _, uid, uv) in enumerate(kfs):
        sel = np.asarray([uid_to_l.get(int(u), -1) for u in uid])
        keep = sel >= 0
        cams.append(np.full(int(keep.sum()), c, np.int64))
        lms.append(sel[keep])
        uvs.append(uv[keep])
    cam_idx = np.concatenate(cams)
    lm_idx = np.concatenate(lms)
    uv = np.concatenate(uvs).astype(np.float32)
    O = len(cam_idx)

    C = -(-K // pad_cameras_to) * pad_cameras_to
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    t = np.zeros((C, 3), np.float32)
    for c, (_, Rc, tc, _, _) in enumerate(kfs):
        R[c] = Rc
        t[c] = tc
    X = np.stack([pos[u] for u in uids]).astype(np.float32)

    p = BAProblem(
        R=jnp.asarray(R), t=jnp.asarray(t),
        X=jnp.asarray(X),
        cam_idx=jnp.asarray(cam_idx, jnp.int32),
        lm_idx=jnp.asarray(lm_idx, jnp.int32),
        uv=jnp.asarray(uv),
        obs_valid=jnp.ones(O, bool),
        cam_valid=jnp.asarray(np.arange(C) < K),
        lm_valid=jnp.ones(L, bool),
    )
    return p, np.asarray([fid for fid, *_ in kfs])


def run_global_ba(slam_map, cfg: BAConfig, corrected: Optional[dict] = None,
                  mesh=None, mesh_axis: str = "shard") -> GlobalBAResult:
    """Optimize the full keyframe history. With `mesh`, the trajectory axis
    is sharded across its devices (parallel/traj_ba.py); otherwise the
    single-chip Schur solver runs."""
    n_shards = 1 if mesh is None else mesh.shape[mesh_axis]
    p, frame_ids = build_global_problem(slam_map, corrected,
                                        pad_cameras_to=n_shards)
    K = len(frame_ids)
    # an explicitly chosen iterative solver is respected; only the dense
    # default auto-switches once the reduced system outgrows direct
    # factorization (matrix-free Schur CG — the [C,6,C,6] system never
    # materializes, benchmarks/ba_scale.json)
    solver = cfg.solver
    if p.R.shape[0] > 64 and solver == "schur_dense":
        solver = "schur_mf"
    run_cfg = cfg.replace(max_cameras=int(p.R.shape[0]),
                          max_landmarks=int(p.X.shape[0]),
                          max_observations=int(p.uv.shape[0]),
                          solver=solver)
    if mesh is None:
        res = run_ba_jit(p, run_cfg)
        R = np.asarray(res.R[:K])
        t = np.asarray(res.t[:K])
    else:
        from visualslam.parallel.traj_ba import (
            run_ba_traj_sharded,
            shard_problem_trajectory,
            unshard_traj,
        )

        sp = shard_problem_trajectory(p, n_shards)
        res = run_ba_traj_sharded(sp, run_cfg, mesh, axis=mesh_axis)
        R, t, _ = unshard_traj(res.R, res.t, res.X, sp.lm_order,
                               int(p.X.shape[0]))
        R, t = R[:K], t[:K]
    return GlobalBAResult(
        frame_ids=frame_ids, R=R, t=t,
        cost=float(res.cost), initial_cost=float(res.initial_cost),
        n_cameras=K, n_landmarks=int(p.X.shape[0]),
        n_observations=int(p.uv.shape[0]))
