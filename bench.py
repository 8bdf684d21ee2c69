"""Benchmark entry point — prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Headline metric: END-TO-END sequence throughput (frames/s per GPU) of the
full SLAM system — batched SIFT frontend + the device-resident tracking
engine (match, PnP, velocity model, triangulation, in-scan window BA and
loop verification as ONE device program per batch, slam/engine.py) — on
KITTI-sized (376x1248) synthetic frames with real parallax. Baseline:
BASELINE.json north_star >= 30 frames/s, so vs_baseline = value / 30.

The frontend-only rate is reported as an extra key in the same object.
Every number is taken on the GPU; with no GPU the script exits non-zero.
Each timed region ends in a host readback of results that depend on all
of its work, and no input buffer is timed twice.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

BASELINE_FPS = 30.0
BATCH = 16
WARMUP = 2
ITERS = 12
SEQ_FRAMES = 96


def bench_frontend(jax, jnp, cfg) -> float:
    from visualslam.frontend import detect_and_describe

    h, w = 376, 1248
    rng = np.random.default_rng(0)
    # uint8 frames: what a production loader ships (KITTI is 8-bit); the
    # frontend normalizes on device. One distinct buffer per call.
    batches = [jnp.asarray(rng.integers(0, 256, (BATCH, h, w),
                                        dtype=np.uint8))
               for _ in range(WARMUP + ITERS)]

    @jax.jit
    def fn(ims):
        feats = jax.vmap(lambda im: detect_and_describe(im, cfg))(ims)
        # scalar checksum depending on every output -> forced full execution
        return (jnp.sum(feats.descriptors) + jnp.sum(feats.keypoints.yx)
                + jnp.sum(feats.keypoints.response))

    for b in batches[:WARMUP]:      # compile + warm up
        float(fn(b))

    t0 = time.perf_counter()
    outs = [fn(b) for b in batches[WARMUP:]]
    for o in outs:
        float(o)
    total = time.perf_counter() - t0
    return ITERS * BATCH / total


def bench_sequence(jax, jnp, cfg, runs: int = 1) -> tuple[float, dict]:
    """Full SLAM over a rendered synthetic sequence (tracking + in-scan
    windowed BA + loop-closure machinery active), driven through the lag-1
    pipelined stream (Tracker.process_stream): each batch's engine program
    is dispatched before the previous batch's telemetry is consumed, so
    the readback overlaps a full batch of device compute. Frames are
    pre-rendered so only the pipeline is timed.
    Returns (median fps over `runs`, diagnostics incl. the run list)."""
    from visualslam.io.kitti import SyntheticSequence
    from visualslam.slam.tracker import Tracker

    # landmark density matched to the image area (~the 240x376 world's
    # density that the CLI default uses)
    seq = SyntheticSequence(num_frames=SEQ_FRAMES + 8, h=376, w=1248,
                            n_dots=8000, step=0.4)
    info = seq.info()
    frames = np.stack([seq.frame(k) for k in range(len(seq))])
    # 8-bit frames, as a production loader would ship them
    frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)

    # warmup tracker: compiles frontend, track/keyframe step, the engine
    # batch program and loop-closure programs. The timed trackers reuse
    # the same compiled programs (slam/tracker._shared_programs /
    # engine_programs). Warmup frames come from a different seed.
    warm_seq = SyntheticSequence(num_frames=24, h=376, w=1248,
                                 n_dots=8000, step=0.4, seed=7)
    warm_frames = np.stack([warm_seq.frame(k) for k in range(24)])
    warm_frames = np.clip(warm_frames * 255.0, 0, 255).astype(np.uint8)
    warm = Tracker(cfg, warm_seq.info().intrinsics)
    warm.process_batch(warm_frames[:8], 0)      # bootstrap/init programs
    warm.process_stream(warm_frames[8:24], 8)   # the timed 16-frame batch
    warm.finish()
    del warm

    B = 16
    fps_runs = []
    diag = {}
    for _ in range(runs):
        tracker = Tracker(cfg, info.intrinsics)
        tracker.process_batch(frames[:8], 0)    # bootstrap + two-view init
        t0 = time.perf_counter()
        for k in range(8, len(frames), B):
            tracker.process_stream(frames[k:k + B], k)
        tracker.finish()
        total = time.perf_counter() - t0
        n = len(frames) - 8
        fps_runs.append(n / total)
        diag = {
            "seq_frames": n,
            "keyframes": int(sum(f.is_keyframe for f in tracker.frames)),
            "landmarks": int(tracker.map.lm_valid.sum()),
            "mean_inliers": float(np.mean(
                [f.num_inliers for f in tracker.frames
                 if f.num_inliers > 0] or [0])),
        }
    fps_runs.sort()
    diag["fps_runs"] = [round(v, 2) for v in fps_runs]
    return fps_runs[len(fps_runs) // 2], diag


def main() -> None:
    import jax
    import jax.numpy as jnp

    from visualslam.utils.config import FAST_CONFIG

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures on a GPU; JAX's default device is "
                 f"{dev.platform}")
    cfg = FAST_CONFIG
    frontend_fps = bench_frontend(jax, jnp, cfg)
    seq_fps, diag = bench_sequence(jax, jnp, cfg, runs=3)

    print(f"[bench] device={dev.device_kind} frontend={cfg.frontend} "
          f"image=376x1248 batch={BATCH} frontend_fps={frontend_fps:.2f} "
          f"sequence_fps={seq_fps:.2f} diag={diag}", file=sys.stderr)
    print(json.dumps({
        "metric": "sequence_frames_per_s",
        "value": round(seq_fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(seq_fps / BASELINE_FPS, 3),
        "frontend_frames_per_s": round(frontend_fps, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **diag,
    }))


if __name__ == "__main__":
    main()
