"""KITTI-scale end-to-end run on one chip (VERDICT r3 item 8 / r4 item 2):
~500 KITTI-sized frames through the FULL stack in one process — batched
frontend + device-resident tracking engine (in-scan windowed BA) + loop
closure, then full-sequence matrix-free global BA — recording throughput,
accuracy and backend rates in ONE artifact. This is the single-chip
analogue of BASELINE configs[4] ("full sequence"), chained end to end
instead of benchmarked as separate pieces.

The trajectory is the loop rectangle (the 500-frame path re-sees its
starting views, so loop closure and the pose graph run for real). Frames
are pre-rendered; only the pipeline is timed, through the lag-1 pipelined
stream (Tracker.process_stream). The global-BA rate is reported BOTH cold
(wall incl. compilation — what one invocation actually costs) and warmed
(the identical solve re-dispatched against the cached executable — the
sustained rate, comparable to benchmarks/ba_scale.py). When zero loop
closures fire, the artifact carries retrieval diagnostics (device-database
cosine similarity for ground-truth revisit pairs) so the failure stage is
identifiable.

Usage: python -m benchmarks.kitti_scale [--frames N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _loop_diagnostics(tracker, info, top: int = 5):
    """For ground-truth revisit pairs (close in space, far in time), what
    cosine similarity did the device loop database record? Distinguishes
    'retrieval gate failing' from 'no true revisits at this length'."""
    import jax

    lc = tracker.loop_closer
    p = tracker._eng_persist
    if lc is None or p is None or len(lc.entries) < 4:
        return None
    n = min(int(tracker._eng_db_n), p.db_g.shape[0], len(lc.entries))
    G = np.asarray(jax.device_get(p.db_g[:n]))
    fids = np.asarray([e.frame_id for e in lc.entries[:n]])
    centers = np.stack([-e.R.T @ e.t for e in lc.entries[:n]])
    sims = G @ G.T
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            if fids[j] - fids[i] < 100:         # temporally distant only
                continue
            d = float(np.linalg.norm(centers[j] - centers[i]))
            out.append((d, float(sims[i, j]), int(fids[i]), int(fids[j])))
    out.sort()
    return [{"gt_dist_est_m": round(d, 2), "cosine": round(s, 3),
             "frames": [a, b]} for d, s, a, b in out[:top]]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=500)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"kitti_scale measures on a GPU, not {dev.platform}")

    from visualslam.io.kitti import SyntheticSequence
    from visualslam.slam.evaluation import (
        ate_rmse, centers_from_poses, rpe)
    from visualslam.slam.global_ba import build_global_problem
    from visualslam.backend.ba import run_ba_jit
    from visualslam.slam.tracker import Tracker
    from visualslam.utils.config import FAST_CONFIG

    N = args.frames
    cfg = FAST_CONFIG.replace(
        ba=FAST_CONFIG.ba.replace(solver="schur_mf"))
    seq = SyntheticSequence(num_frames=N, h=376, w=1248, n_dots=12000,
                            step=0.4, trajectory="loop")
    info = seq.info()
    print(f"[kitti_scale] rendering {N} frames...", file=sys.stderr)
    frames = np.stack([seq.frame(k) for k in range(N)])
    frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)

    # warmup on a different world so the timed run measures execution,
    # not compilation
    warm_seq = SyntheticSequence(num_frames=24, h=376, w=1248,
                                 n_dots=12000, step=0.4, seed=7)
    wf = np.clip(np.stack([warm_seq.frame(k) for k in range(24)]) * 255.0,
                 0, 255).astype(np.uint8)
    warm = Tracker(cfg, warm_seq.info().intrinsics)
    warm.process_batch(wf[:8], 0)
    warm.process_stream(wf[8:24], 8)
    warm.finish()
    warm.prewarm_aux()      # pose graph / db-correct / relocalize programs
    del warm

    tracker = Tracker(cfg, info.intrinsics)
    tracker.process_batch(frames[:8], 0)        # bootstrap + two-view init
    t0 = time.perf_counter()
    B = 16
    for k in range(8, N, B):
        tracker.process_stream(frames[k:k + B], k)
    tracker.finish()
    track_wall = time.perf_counter() - t0
    fps = (N - 8) / track_wall

    est = tracker.trajectory()
    gt = info.gt_poses[: len(est)]
    ate_track = float(ate_rmse(centers_from_poses(est),
                               centers_from_poses(gt)))
    loop_diag = (None if tracker.num_loop_closures > 0
                 else _loop_diagnostics(tracker, info))

    t0 = time.perf_counter()
    res = tracker.global_ba()
    gba_wall_cold = time.perf_counter() - t0
    est2 = tracker.trajectory()
    ate_gba = float(ate_rmse(centers_from_poses(est2),
                             centers_from_poses(gt)))
    t_rmse, r_rmse = rpe(est2, gt)

    # warmed solve rate: re-dispatch the IDENTICAL-shape solve against the
    # cached executable (post-writeback init values; fixed iteration count
    # so per-iteration work is unchanged)
    p2, _ = build_global_problem(tracker.map)
    solver = "schur_mf"
    run_cfg = cfg.ba.replace(max_cameras=int(p2.R.shape[0]),
                             max_landmarks=int(p2.X.shape[0]),
                             max_observations=int(p2.uv.shape[0]),
                             solver=solver)
    t0 = time.perf_counter()
    jax.block_until_ready(run_ba_jit(p2, run_cfg).R)
    gba_wall_warm = time.perf_counter() - t0

    inl = [f.num_inliers for f in tracker.frames if f.num_inliers > 0]
    ba_cfg = tracker.cfg.ba
    out = {
        "device": str(jax.devices()[0]),
        "frames": N, "image": "376x1248", "profile": "fast",
        "batch": B,
        "sequence_fps": round(fps, 2),
        "track_wall_s": round(track_wall, 2),
        "keyframes": int(sum(f.is_keyframe for f in tracker.frames)),
        "loop_closures": int(tracker.num_loop_closures),
        "relocalizations": int(tracker.relocalizations),
        "landmarks_live": int(tracker.map.lm_valid.sum()),
        "mean_inliers": round(float(np.mean(inl)), 1) if inl else 0.0,
        "ate_tracked_m": round(ate_track, 4),
        "global_ba": {
            "solver": "schur_mf",
            "cameras": int(res.n_cameras),
            "landmarks": int(res.n_landmarks),
            "observations": int(res.n_observations),
            "initial_cost": float(res.initial_cost),
            "final_cost": float(res.cost),
            "wall_s_cold_incl_compile": round(gba_wall_cold, 2),
            "wall_s_warm": round(gba_wall_warm, 2),
            "lm_iters_per_s_warm": round(
                ba_cfg.iters / max(gba_wall_warm, 1e-9), 2),
        },
        "ate_after_gba_m": round(ate_gba, 4),
        "rpe_trans_m": round(float(t_rmse), 4),
        "rpe_rot_deg": round(float(r_rmse), 4),
    }
    if loop_diag is not None:
        out["loop_retrieval_diagnostics"] = loop_diag
    print(json.dumps(out))


if __name__ == "__main__":
    main()
