"""Monocular SLAM tracking loop.

The "tied together" SLAM solution the reference's README promises
(README.md:24) but never builds. Host-side orchestration (this file) is thin
bookkeeping; every compute phase is a jitted fixed-shape device program:

  frontend  detect_and_describe (SIFT/ORB)          models/
  matching  ratio+mutual matcher                    models/matching
  init      essential RANSAC + triangulation        geometry/
  tracking  motion-only LM (PnP refine)             backend/pnp
  mapping   DLT triangulation of new landmarks      geometry/epipolar
  backend   sliding-window Schur BA                 backend/ba

Pose convention: world-to-camera (x_cam = R X_w + t); world frame = first
keyframe. Monocular scale is fixed at two-view init by normalizing median
scene depth to `init_depth`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from visualslam.backend.ba import (
    BAProblem,
    run_ba_packed_jit,
    unpack_ba_result,
)
from visualslam.frontend import detect_and_describe
from visualslam.geometry import sim3
from visualslam.geometry.camera import normalized
from visualslam.geometry.ransac import estimate_relative_pose
from visualslam.models.matching import match_features
from visualslam.models.types import Features, Keypoints
from visualslam.slam.track_step import (
    KeyframeRef,
    LocalMap,
    TrackState,
    build_local_map,
    index_features,
    keyframe_step,
    lite_at,
    pack_keyframe_products,
    track_batch,
    track_step_lite,
    unpack_keyframe_products,
)
from visualslam.utils.config import SlamConfig


@functools.lru_cache(maxsize=32)
def _shared_programs(cfg: SlamConfig, ok_min: int, max_depth: float):
    """Jitted device programs shared by every Tracker with an equal config.

    A fresh Tracker used to build fresh jax.jit lambdas, so each instance
    recompiled the whole pipeline (tens of seconds) — benchmarks and CLI runs paid full compilation inside the
    timed/tracked region even after a warmup tracker had compiled
    identical programs. SlamConfig is frozen/hashable, so programs cache
    per config."""
    frontend = jax.jit(lambda im: detect_and_describe(im, cfg))

    def _kf_step(kf, fb, i, bl, intr):
        feats = index_features(fb, i)
        lite = lite_at(bl, i)
        full = keyframe_step(kf, feats, lite, intr, cfg, max_depth)
        # one packed f32 buffer + the sliced device-side Features: the
        # host fetches (packed, feats.descriptors) in a 2-leaf device_get.
        # (bf16 descriptor transfer was tried and reverted: the rounded
        # copies feed the loop database and the local map, and the ~0.4%
        # descriptor noise measurably degraded loop-correction quality.)
        return pack_keyframe_products(full, feats), feats

    return {
        "frontend": frontend,
        "frontend_batched": jax.jit(jax.vmap(
            lambda im: detect_and_describe(im, cfg))),
        "match": jax.jit(lambda fa, fb: match_features(fa, fb, cfg.match)),
        "ransac": jax.jit(lambda x1, x2, v, k: estimate_relative_pose(
            x1, x2, v, cfg.ransac, k)),
        "track_lite": jax.jit(
            lambda lmap, fb, i, state, intr: track_step_lite(
                lmap, index_features(fb, i), state, intr, cfg, ok_min)),
        # whole-batch tracking scan: ONE dispatch + ONE [B,22] readback
        # per batch (start index re-enters mid-batch after restarts)
        "track_batch": jax.jit(
            lambda lmap, fb, start, state, intr: track_batch(
                lmap, fb, start, state, intr, cfg, ok_min)),
        "kf_step": jax.jit(_kf_step),
        # [n, 22] stats matrix: ONE readback per speculation round instead
        # of one per frame (compiles once per distinct n <= batch size)
        "stack_stats": jax.jit(lambda ss: jnp.stack(ss)),
    }


def _transform_telemetry(G, stats, recs, tail):
    """Move one batch's decoded engine telemetry from the pre-correction
    world frame into the corrected frame: points X' = s (X @ Rg^T) + tg,
    world-to-camera poses T' = descale(T . G^-1) — the same Sim(3) the
    loop correction applied to the host map and the device state
    (slam/engine.apply_correction)."""
    Rg, tg, sg = G
    Rgi = Rg.T
    tgi = -(Rg.T @ tg) / sg
    sgi = 1.0 / sg

    def pose(R, t):
        return R @ Rgi, (R @ tgi + t) / sgi

    def points(X):
        return sg * (X @ Rg.T) + tg

    stats = stats.copy()
    for j in range(stats.shape[0]):
        R, t = pose(stats[j, 4:13].reshape(3, 3), stats[j, 13:16])
        stats[j, 4:13] = R.reshape(-1)
        stats[j, 13:16] = t
    out_recs = []
    for r in recs:
        # loop-verify rows carry the candidate camera's ABSOLUTE pose in
        # the (old) verification frame — add_device_edge composes it with
        # the corrected entry pose, so it must move frames too
        loop = r.loop.copy()
        for c in range(loop.shape[0]):
            Rv, tv = pose(loop[c, 4:13].reshape(3, 3), loop[c, 13:16])
            loop[c, 4:13] = Rv.reshape(-1)
            loop[c, 13:16] = tv
        out_recs.append(r._replace(tri_X=points(r.tri_X), loop=loop))
    recs = out_recs
    win_R = tail.win_R.copy()
    win_t = tail.win_t.copy()
    for w in range(win_R.shape[0]):
        win_R[w], win_t[w] = pose(win_R[w], win_t[w])
    tail = tail._replace(win_R=win_R, win_t=win_t,
                         lm_X=points(tail.lm_X))
    return stats, recs, tail


@dataclass
class FrameResult:
    frame_id: int
    R: np.ndarray               # world-to-camera
    t: np.ndarray
    num_matches: int = 0
    num_inliers: int = 0
    is_keyframe: bool = False
    tracking_ok: bool = True


class Tracker:
    """Monocular tracker with sliding-window BA."""

    def __init__(self, cfg: SlamConfig, intrinsics, init_depth: float = 20.0,
                 run_ba: bool = True, loop_closure: bool | None = None,
                 mesh=None, engine: bool = True):
        """mesh: optional jax.sharding.Mesh with a 'shard' axis — window BA
        (and global_ba unless overridden) runs trajectory-sharded across its
        devices (parallel/traj_ba.py).

        engine: process_batch runs the device-resident engine
        (slam/engine.py — keyframe promotion, local-map maintenance and
        loop retrieval/verification all inside ONE scanned device program
        per batch). False falls back to the round-3 host-orchestrated
        keyframe path (one extra dispatch/readback round per keyframe)."""
        from visualslam.slam.map_state import SlamMap

        if cfg.frontend == "orb" and cfg.match.metric != "hamming":
            # ORB descriptors are bit-packed uint32 — L2 on packed words is
            # meaningless; switch to Hamming automatically
            cfg = cfg.replace(match=cfg.match.replace(metric="hamming"))
        self.cfg = cfg
        self.intr = jnp.asarray(intrinsics, jnp.float32)
        self.init_depth = init_depth
        self.run_ba = run_ba
        self.mesh = mesh
        # landmark pool decoupled from the BA padded shapes (ADVICE r4):
        # the live pool must absorb feature-rich scenes without recycling
        # still-observed slots; BA problems compact to their own capacity
        self.map_landmarks = max(cfg.map_landmarks, cfg.ba.max_landmarks)
        if loop_closure is None:
            loop_closure = cfg.loop.enabled
        self.loop_closer = None
        if loop_closure:
            from visualslam.slam.loop_closure import LoopCloser

            self.loop_closer = LoopCloser(
                intrinsics, cfg.match, cfg.pose_graph,
                sub_keypoints=cfg.loop.sub_keypoints,
                cosine_threshold=cfg.loop.cosine_threshold,
                min_inliers=cfg.loop.min_inliers,
                exclude_recent=cfg.loop.exclude_recent,
                use_sim3=cfg.loop.sim3,
                max_scale=cfg.loop.max_scale)
        self.num_loop_closures = 0
        self._loop_cooldown_until = -1   # db index gating closure acceptance
        feat_cap = (cfg.sift.max_keypoints if cfg.frontend == "sift"
                    else cfg.orb.max_keypoints)
        self.map = SlamMap(cfg.ba.max_cameras, self.map_landmarks, feat_cap)
        self.frames: list[FrameResult] = []
        self._prev_feats: Optional[Features] = None
        self._frames_since_kf = 0
        self._last_R = np.eye(3, dtype=np.float32)
        self._last_t = np.zeros(3, np.float32)
        self._vel = np.zeros(6, np.float32)  # constant-velocity model (twist)
        self._lost_streak = 0
        self.relocalizations = 0       # recoveries (re-init or db reloc)
        self.db_relocalizations = 0    # recoveries that PnP'd into the db
        self.max_lost_frames = 5  # consecutive failures before re-init

        self._key = jax.random.PRNGKey(cfg.ransac.seed)

        # fused per-frame tracking programs (slam/track_step.py): everything
        # between the frontend and the keyframe bookkeeping is ONE device
        # execution per frame (lite), plus one keyframe-products execution
        # on the ~1-in-5 frames that get promoted; pose state chains
        # device-to-device between frames. Programs are shared across
        # Tracker instances with equal configs (_shared_programs).
        self._track_ok_min = max(10, cfg.keyframe_min_inliers // 3)
        progs = _shared_programs(cfg, self._track_ok_min,
                                 float(init_depth) * 20.0)
        self._frontend = progs["frontend"]
        self._frontend_batched = progs["frontend_batched"]
        self._match = progs["match"]
        self._ransac = progs["ransac"]
        self._track_lite = progs["track_lite"]
        self._track_batch = progs["track_batch"]
        self._kf_step = progs["kf_step"]
        self._stack_stats = progs["stack_stats"]
        # device-side caches, rebuilt at every keyframe / correction
        self._kf_ref: Optional[KeyframeRef] = None
        self._lmap: Optional[LocalMap] = None
        self._lmap_ids = np.full(cfg.local_map_size, -1, np.int64)
        self._state: Optional[TrackState] = None
        # device-resident engine state (slam/engine.py)
        self.engine = engine
        from visualslam.slam import engine as _engine

        self._eng_progs = _engine.engine_programs(
            cfg, self._track_ok_min, float(init_depth) * 20.0)
        self._eng_persist = None     # EnginePersist (device pytree)
        self._eng_ids = None         # [Kl] map landmark slot per engine slot
        self._eng_uids = None        # [Kl] landmark uid at association time
        self._eng_gen = None         # [Kl] mirror of the device lm_gen
        self._eng_db_n = 0           # loop-database entries in the ring
        self._eng_ready = False      # device state in sync with host map
        # lag-1 pipelined stream state (process_stream): the in-flight
        # batch whose packed telemetry has not been harvested yet
        self._inflight = None   # (packed_dev, feats_b, first_fid, i0, B, stop)
        self._stream_B = None   # compiled stream batch size (tail padding)
        # world-frame Sim(3) to apply to the NEXT harvest's decoded
        # telemetry: when a loop correction lands while a speculative
        # batch is in flight, that batch executed in the PRE-correction
        # frame (the device program queue corrects right after it, so the
        # device state is consistent — tracking is similarity-equivariant)
        # but its decoded poses/points must be moved into the corrected
        # frame before they touch the host map / loop database
        self._pending_world_G = None    # (Rg, tg, sg) or None
        # optional utils.profiling.StageTimer — set by benchmarks/CLI to
        # attribute wall time to pipeline stages (readbacks absorb device
        # time; dispatch stages measure host dispatch cost only)
        self.timer = None

    def _stage(self, name: str):
        if self.timer is None:
            import contextlib

            return contextlib.nullcontext()
        return self.timer.stage(name)

    # ------------------------------------------------------------------

    def process(self, img: np.ndarray, frame_id: int) -> FrameResult:
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = img.astype(np.float32, copy=False)
        feats = self._frontend(jnp.asarray(img))
        return self.process_features(feats, frame_id)

    def detect_batch(self, imgs: np.ndarray) -> Features:
        """Batched detection: [B, H, W] -> Features with leading batch axis.

        One device execution for B frames (amortizes dispatch overhead). Slice per-frame Features with `features_at`.
        uint8 input is uploaded as-is (4x cheaper transfer) and normalized
        to [0, 1] float on device."""
        if not isinstance(imgs, jax.Array):
            imgs = np.asarray(imgs)
            if imgs.dtype != np.uint8:
                imgs = imgs.astype(np.float32, copy=False)
            imgs = jnp.asarray(imgs)
        return self._frontend_batched(imgs)

    def upload_batch(self, imgs: np.ndarray) -> jax.Array:
        """Explicit host->device upload of a frame batch. Call from a
        prefetch thread to overlap the next batch's transfer with the
        current batch's compute, then pass the device array to
        process_batch."""
        imgs = np.asarray(imgs)
        if imgs.dtype != np.uint8:
            imgs = imgs.astype(np.float32, copy=False)
        return jax.device_put(imgs)

    @staticmethod
    def features_at(batched: Features, i: int) -> Features:
        """Extract frame i's Features from a batched Features pytree."""
        return jax.tree_util.tree_map(lambda x: x[i], batched)

    def process_batch(self, imgs: np.ndarray, first_frame_id: int):
        """Detect a batch in one device call, then track the WHOLE batch
        in one scanned device program (track_batch: pose chained inside
        the scan) and read back one [B, 22] stats matrix. After a mid-
        batch keyframe promotion the device caches are refreshed and the
        scan re-enters at the next frame — frames after a promotion MUST
        see the new keyframe's landmarks (a deferred variant that let
        them ride the stale local map was measured to triple ATE on
        turning trajectories: the new scenery's landmarks are exactly
        what keeps tracking alive there). Cost: one extra dispatch +
        readback round per keyframe."""
        B = imgs.shape[0]
        with self._stage("frontend_dispatch"):
            feats_b = self.detect_batch(imgs)
        results: list[FrameResult] = []
        i = 0
        while i < B:
            fid = first_frame_id + i
            if not self.map.kf_order or not self.map.lm_valid.any():
                # bootstrap / two-view init are host-driven paths
                results.append(self.process_features(
                    self.features_at(feats_b, i), fid))
                i += 1
                continue
            if self.engine:
                out, i = self._engine_run(feats_b, first_frame_id, i, B)
                results.extend(out)
                continue
            if self._kf_ref is None:
                self._refresh_device_cache()
            with self._stage("track_dispatch"):
                st, bl = self._track_batch(self._lmap, feats_b,
                                           np.int32(i), self._state,
                                           self.intr)
            with self._stage("stats_readback"):
                stats = np.asarray(bl.stats)        # ONE [B, 22] readback
            self._state = st
            disp = "ok"
            j = i
            while j < B:
                res, disp = self._commit_tracked_frame(
                    first_frame_id + j, feats_b, bl, j, stats[j])
                results.append(res)
                j += 1
                if disp in ("kf", "restart"):
                    break
            i = j
            if disp == "kf":
                # fold the new keyframe (landmarks + BA/loop-adjusted
                # poses) into the device caches, then re-enter the scan
                # at the next frame
                with self._stage("refresh_cache"):
                    self._refresh_device_cache()
            # "restart": recovery reset the map/caches itself
        return results

    # ------------------------------------------------------------------
    # lag-1 pipelined streaming (the throughput path)
    # ------------------------------------------------------------------

    def process_stream(self, imgs: np.ndarray, first_frame_id: int):
        """Pipelined batch processing: dispatch THIS batch's frontend +
        engine program, then harvest the PREVIOUS batch's telemetry — the
        packed readback's round-trip latency hides behind a full batch of
        device compute (engine state chains device-to-device, so the next
        batch never waits for the host). Call `finish()` after the last
        batch to harvest the tail.

        Returns the FrameResults committed by THIS call (usually the
        previous batch's frames — committed results also accumulate in
        `self.frames`). Falls back to synchronous processing while the
        engine isn't active (bootstrap, two-view init, recovery)."""
        out: list[FrameResult] = []
        if (not self.engine or not self.map.kf_order
                or not self.map.lm_valid.any()):
            out.extend(self.finish())
            out.extend(self.process_batch(imgs, first_frame_id))
            return out
        n = imgs.shape[0]
        # pad short tail batches up to the compiled batch size: the engine
        # program is shape-specialized per B, and a one-off remainder
        # batch costs a full recompile inside the production loop
        B = max(self._stream_B or 0, n)
        self._stream_B = B
        if n < B:
            imgs = np.asarray(imgs)
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], B - n, axis=0)])
        with self._stage("frontend_dispatch"):
            feats_b = self.detect_batch(imgs)
        # the engine program for this batch is dispatched BEFORE the
        # previous batch's telemetry is consumed — safe because nothing in
        # EngineDyn depends on it (kill lists simply land one batch late)
        prev = self._inflight
        self._inflight = self._engine_dispatch(feats_b, first_frame_id,
                                               0, B, stop=n)
        if prev is not None:
            out.extend(self._harvest_inflight(prev))
        return out

    def finish(self) -> list:
        """Harvest any in-flight pipelined batch (call after the last
        process_stream, and before reading trajectories/maps)."""
        inflight, self._inflight = self._inflight, None
        if inflight is None:
            return []
        return self._harvest_inflight(inflight)

    def prewarm_aux(self) -> None:
        """Compile the rare-event device programs (pose graph + device
        correction, database relocalization) OUTSIDE any timed loop. The
        first loop closure / recovery of a run otherwise pays ~30-60 s of
        compilation mid-sequence. Call on a warmup tracker that has
        already tracked a few batches (so the engine persist and at least
        two loop-database entries exist); it corrupts that tracker's
        state, so only warmup trackers should call it."""
        lc = self.loop_closer
        if lc is None or self._eng_persist is None or len(lc.entries) < 2:
            return
        lc.add_device_edge(0, len(lc.entries) - 1,
                           np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32), 99, 1.0)
        self._engine_apply_loops()
        if self._prev_feats is not None:
            import jax as _jax

            _jax.block_until_ready(self._eng_progs["relocalize"](
                self._eng_persist, jnp.int32(max(1, self._eng_db_n)),
                self._prev_feats, self.intr))

    def _harvest_inflight(self, inflight) -> list:
        """Harvest a dispatched batch. If the harvest aborts mid-batch
        (sustained tracking loss -> recovery), any batch dispatched AFTER
        it speculated from a lost state: discard its device results and
        re-track its frames through the synchronous path (detection is
        reused — the feats handle is still on device)."""
        packed_dev, feats_b, first_fid, i0, B, stop = inflight
        results, nxt = self._engine_harvest(inflight)
        if nxt < stop:
            # recovery happened inside this batch: the speculative next
            # batch (if any) ran on a corrupt state — reprocess both tails
            # synchronously (rare; costs one exposed round trip)
            spec, self._inflight = self._inflight, None
            res2 = self.process_batch_features(feats_b, first_fid, nxt,
                                               stop)
            results.extend(res2)
            if spec is not None:
                _, feats_s, fid_s, _, _, stop_s = spec
                results.extend(
                    self.process_batch_features(feats_s, fid_s, 0, stop_s))
        return results

    def process_batch_features(self, feats_b, first_fid: int, i0: int,
                               stop: int) -> list:
        """Synchronously track frames [i0, stop) of an already-detected
        batch (bootstrap/init/recovery handled per frame, engine re-entered
        once the map is live). The batch may be padded past `stop`."""
        B = int(feats_b.keypoints.valid.shape[0])
        results: list[FrameResult] = []
        i = i0
        while i < stop:
            if (self.engine and self.map.kf_order
                    and self.map.lm_valid.any()):
                out, i = self._engine_run(feats_b, first_fid, i, B, stop)
                results.extend(out)
                continue
            results.append(self.process_features(
                self.features_at(feats_b, i), first_fid + i))
            i += 1
        return results

    # ------------------------------------------------------------------
    # device-resident engine (slam/engine.py)
    # ------------------------------------------------------------------

    def _engine_enter(self) -> None:
        """(Re)build the engine's device state from the host map — on first
        engine batch after bootstrap/init, after a recovery, or after a
        checkpoint resume. A surviving device loop database is carried
        forward (its entries stay retrievable for relocalization)."""
        from visualslam.slam.engine import build_persist_from_host

        entries = self.loop_closer.entries if self.loop_closer else None
        persist, ids, db_n = build_persist_from_host(
            self.map, self.cfg, self._last_R, self._last_t, self._vel,
            self._frames_since_kf, db_entries=entries,
            old_persist=self._eng_persist, db_count=self._eng_db_n)
        self._eng_persist = persist
        self._eng_ids = ids.astype(np.int64)
        g = np.maximum(ids, 0)
        self._eng_uids = np.where(ids >= 0, self.map.lm_uid[g], -1)
        self._eng_gen = np.zeros(len(ids), np.int64)
        if db_n is not None:
            self._eng_db_n = db_n
        self._eng_ready = True

    def _engine_dyn(self, start_i: int, first_fid: int, stop_i: int):
        """Per-batch host->device upload: frame counters + the (usually
        empty) kill list for engine slots whose host landmark was recycled
        or invalidated since the last batch. Everything else — pose state,
        window, local map, loop database — chains device-to-device in
        EnginePersist."""
        from visualslam.slam.engine import EngineDyn

        ids = self._eng_ids
        g = np.maximum(ids, 0)
        stale = (ids >= 0) & ~(self.map.lm_valid[g]
                               & (self.map.lm_uid[g] == self._eng_uids))
        kill_gen = np.where(stale, self._eng_gen, -1).astype(np.int32)
        ids[stale] = -1
        self._eng_uids[stale] = -1
        return EngineDyn(
            frame_base=jnp.int32(first_fid),
            start=jnp.int32(start_i),
            stop=jnp.int32(stop_i),
            kill=jnp.asarray(stale),
            kill_gen=jnp.asarray(kill_gen))

    def _engine_dispatch(self, feats_b, first_fid: int, i0: int, B: int,
                         stop: int | None = None):
        """Dispatch the whole-batch engine program (async) and start the
        device->host copy of its packed telemetry. B is the COMPILED batch
        size; frames [i0, stop) are active (stop < B when the batch was
        padded to avoid a tail-size recompile). Returns the in-flight
        record for _engine_harvest."""
        if stop is None:
            stop = B
        if not self._eng_ready:
            self._engine_enter()
        with self._stage("engine_dyn"):
            dyn = self._engine_dyn(i0, first_fid, stop)
        with self._stage("engine_dispatch"):
            packed_dev, persist = self._eng_progs["batch"](
                self._eng_persist, dyn, feats_b, self.intr)
        self._eng_persist = persist
        try:
            # start the device-to-host copy as soon as the program
            # finishes, so a lag-1 np.asarray is ~free
            packed_dev.copy_to_host_async()
        except AttributeError:
            pass
        return (packed_dev, feats_b, first_fid, i0, B, stop)

    def _engine_harvest(self, inflight):
        """Consume one dispatched batch's telemetry: decode stats +
        promotion records, mirror the post-BA window poses and landmark
        positions into the host map, drive loop-closure pose graphs, and
        handle tracking-loss recovery. Returns (FrameResults, next index)
        — next < B only when a sustained loss forced a mid-batch
        recovery."""
        from visualslam.slam.engine import decode_packed

        packed_dev, feats_b, first_fid, i0, B, stop = inflight
        with self._stage("engine_readback"):
            packed = np.asarray(packed_dev)
        M = self.cfg.match.max_matches
        P = max(1, -(-B // max(1, self.cfg.keyframe_min_gap)))
        W = self.cfg.ba.max_cameras
        Kl = self.cfg.local_map_size
        with self._stage("decode"):
            stats, recs, db_n_dev, tail = decode_packed(
                packed, B, M, P, W, Kl)
            rec_by_frame = {r.frame: r for r in recs}
        pending, self._pending_world_G = self._pending_world_G, None
        if pending is not None:
            stats, recs, tail = _transform_telemetry(
                pending, stats, recs, tail)
            rec_by_frame = {r.frame: r for r in recs}

        results: list[FrameResult] = []
        loop_hits = []
        n_applied = 0
        for j in range(i0, stop):
            fid = first_fid + j
            srow = stats[j]
            n_match = int(srow[0])
            n_inl = int(srow[1])
            R = srow[4:13].reshape(3, 3).astype(np.float32)
            t = srow[13:16].astype(np.float32)
            promoted = srow[22] > 0.5
            ok = n_inl >= self._track_ok_min
            self._frames_since_kf += 1
            self._vel = srow[16:22].astype(np.float32)
            if not ok:
                self._lost_streak += 1
                if self._lost_streak > self.max_lost_frames:
                    # commit what was applied, then host-driven recovery;
                    # device db entries past the applied count are dropped
                    # (the re-enter reseeds the ring write index)
                    self._eng_db_n += n_applied
                    from_db = self._recover(
                        self.features_at(feats_b, j), fid)
                    results.append(self._store_result(
                        fid, self._last_R, self._last_t,
                        num_matches=n_match, num_inliers=0,
                        is_keyframe=True, tracking_ok=from_db))
                    return results, j + 1
            else:
                self._lost_streak = 0
            if promoted:
                rec = rec_by_frame[j]
                with self._stage("kf_apply"):
                    hit = self._engine_apply_prom(rec, fid, R, t)
                n_applied += 1
                self._frames_since_kf = 0
                if hit is not None:
                    loop_hits.append(hit)
                results.append(self._store_result(
                    fid, R, t, num_matches=rec.n2d, num_inliers=n_inl,
                    is_keyframe=True, tracking_ok=True))
            else:
                results.append(self._store_result(
                    fid, R, t, num_matches=n_match, num_inliers=n_inl,
                    is_keyframe=False, tracking_ok=ok))
        self._eng_db_n = db_n_dev
        with self._stage("tail_apply"):
            self._engine_apply_tail(tail)
        if loop_hits:
            with self._stage("loop_optimize"):
                self._engine_apply_loops()
        return results, stop

    def _engine_run(self, feats_b, first_fid: int, i0: int, B: int,
                    stop: int | None = None):
        """Synchronous dispatch + harvest (the non-pipelined path)."""
        return self._engine_harvest(
            self._engine_dispatch(feats_b, first_fid, i0, B, stop))

    def _engine_apply_tail(self, tail) -> None:
        """Mirror the engine's post-BA state into the host map: window
        keyframe poses (matched by frame id) and landmark positions
        (matched through the slot mirror + uid check). The host map is a
        lag-1 replica — global BA, the loop-closure pose graph, and
        checkpoints read it; tracking itself never does."""
        fid_to_slot = {int(self.map.kf_frame_id[s]): s
                       for s in self.map.kf_order}
        for w in range(len(tail.win_valid)):
            if not tail.win_valid[w]:
                continue
            s = fid_to_slot.get(int(tail.win_fid[w]))
            if s is not None:
                self.map.kf_R[s] = tail.win_R[w]
                self.map.kf_t[s] = tail.win_t[w]
        ids = self._eng_ids
        g = np.maximum(ids, 0)
        ok = ((ids >= 0) & tail.lm_valid[:len(ids)]
              & self.map.lm_valid[g]
              & (self.map.lm_uid[g] == self._eng_uids))
        self.map.X[g[ok]] = tail.lm_X[:len(ids)][ok]
        if tail.ba_cost >= 0:
            self.last_ba_cost = tail.ba_cost

    def _engine_apply_prom(self, rec, fid: int, R, t):
        """Fold one device promotion record into the host map: keyframe
        slot, tracked-landmark observations, new landmarks (already
        triangulated + slot-assigned on device), the loop-database mirror
        entry, and any verified loop edge. Returns (slot, db_idx) when an
        edge was accepted, else None."""
        prev_kf = self.map.last_keyframe_slot()
        slot, _ = self.map.allocate_keyframe()
        self.map.set_keyframe(slot, fid, R, t, None, None, None)

        ids = self._eng_ids
        Kl = len(ids)
        gid = ids[np.clip(rec.lm_slot, 0, Kl - 1)]
        sel = rec.lm_obs & (rec.lm_slot < Kl) & (gid >= 0)
        g = np.maximum(gid, 0)
        sel &= (self.map.lm_valid[g]
                & (self.map.lm_uid[g]
                   == self._eng_uids[np.clip(rec.lm_slot, 0, Kl - 1)]))
        if sel.any():
            self.map.add_observations(slot, gid[sel], rec.lm_x[sel])
            self.map.kf_kp_lm[slot][rec.lm_kp[sel]] = gid[sel]

        good = rec.tri_good & (rec.tri_slot >= 0) & (rec.tri_slot < Kl)
        if good.any():
            lm_idx = self.map.allocate_landmarks(rec.tri_X[good])
            self.map.add_observations(prev_kf, lm_idx, rec.m_x1[good])
            self.map.add_observations(slot, lm_idx, rec.m_x2[good])
            self.map.kf_kp_lm[prev_kf][rec.m_idx_a[good]] = lm_idx
            self.map.kf_kp_lm[slot][rec.m_idx_b[good]] = lm_idx
            ts = rec.tri_slot[good]
            ids[ts] = lm_idx
            self._eng_uids[ts] = self.map.lm_uid[lm_idx]
            # replay the device's allocation-generation increments so the
            # host mirror stays aligned with persist.lm_gen (kill lists and
            # telemetry writebacks are gated on generation equality)
            self._eng_gen[ts] += 1

        if self.loop_closer is None:
            return None
        lc = self.loop_closer
        db_idx = lc.add_keyframe_light(fid, R, t)
        if db_idx < self._loop_cooldown_until:
            # closure cooldown: corridor-overlap revisits re-fire every
            # few keyframes with noisy Sim(3) scale estimates; repeated
            # live-map warps were measured to kill tracking outright
            return None
        for row in rec.loop:
            from visualslam.slam.engine import (
                decode_loop_row, loop_row_accept)

            r = decode_loop_row(row)
            # n_usable only needs to clear the symmetric-rule floor: the
            # mutual inlier gates are the real quality bar, and a genuine
            # revisit can be landmark-poor on the current side (measured:
            # a 17-usable / 58-reciprocal-inlier true revisit)
            if (0 <= r.cand < db_idx and r.sim >= lc.cos_thresh
                    and r.n_usable >= max(1, lc.min_inliers // 2)
                    and loop_row_accept(
                        r, lc.min_inliers,
                        self.cfg.loop.consistency_rot_deg,
                        self.cfg.loop.consistency_trans,
                        self.cfg.loop.max_baseline_frac)):
                lc.add_device_edge(r.cand, db_idx, r.R, r.t, r.n_inl,
                                   r.scale,
                                   rot_sigma_deg=r.rot_consist_deg)
                self.num_loop_closures += 1
                self._loop_cooldown_until = (
                    db_idx + self.cfg.loop.cooldown_keyframes)
                return (slot, db_idx)
        return None

    def _engine_apply_loops(self) -> None:
        """Pose-graph optimization for loop edges accepted this batch, then
        correction of the host window (poses + landmarks), of the device
        database (entry poses + landmark snapshots), and of the device LIVE
        state (local map, window ring, pose state) — all via one device
        program, no re-enter."""
        lc = self.loop_closer
        lc.optimize()
        db_idx = len(lc.entries) - 1
        self._apply_loop_correction(self.map.last_keyframe_slot(), db_idx)
        # propagate into the device database ring + live state
        n = min(len(lc.entries), self._eng_persist.db_g.shape[0])
        CAP = self._eng_persist.db_g.shape[0]
        Rg = np.tile(np.eye(3, dtype=np.float32), (CAP, 1, 1))
        tg = np.zeros((CAP, 3), np.float32)
        sg = np.ones(CAP, np.float32)
        Rc = np.tile(np.eye(3, dtype=np.float32), (CAP, 1, 1))
        tc = np.zeros((CAP, 3), np.float32)
        for k in range(n):
            Rg[k], tg[k], sg[k] = lc.last_corrections[k]
            Rc[k], tc[k] = lc.corrected[k]
        # the live state moves by the LATEST keyframe's world correction
        if lc.last_corrections is not None and db_idx < len(
                lc.last_corrections):
            Rl, tl, sl = lc.last_corrections[db_idx]
        else:
            Rl, tl, sl = np.eye(3, dtype=np.float32), np.zeros(
                3, np.float32), 1.0
        self._eng_persist = self._eng_progs["db_correct"](
            self._eng_persist, jnp.asarray(Rg), jnp.asarray(tg),
            jnp.asarray(sg), jnp.asarray(Rc), jnp.asarray(tc),
            jnp.int32(n), jnp.asarray(Rl, jnp.float32),
            jnp.asarray(tl, jnp.float32), jnp.float32(sl))
        if self._inflight is not None:
            # a speculative batch already executed in the pre-correction
            # frame (the correction program is queued right after it);
            # its decoded telemetry must be moved into the corrected frame
            self._pending_world_G = (np.asarray(Rl, np.float32),
                                     np.asarray(tl, np.float32), float(sl))

    def _engine_append_host_entry(self, entry) -> None:
        """Mirror a host-path loop-database entry (e.g. the two-view-init
        keyframes after a recovery) into the device ring so ring indices
        stay aligned with LoopCloser.entries."""
        if self._eng_persist is None or entry.desc is None:
            self._eng_db_n += 1
            return
        p = self._eng_persist
        Ks, Df = p.db_desc.shape[1], p.db_desc.shape[2]
        k = min(Ks, entry.desc.shape[0])

        def fit(a, shape, dtype=np.float32):
            out = np.zeros(shape, dtype)
            out[:k] = a[:k]
            return out

        self._eng_persist = self._eng_progs["db_append"](
            p, jnp.int32(self._eng_db_n),
            jnp.asarray(entry.global_desc.astype(np.float32)),
            jnp.asarray(fit(entry.desc, (Ks, Df))),
            jnp.asarray(fit(entry.yx, (Ks, 2))),
            jnp.asarray(fit(entry.lm_world, (Ks, 3))),
            jnp.asarray(fit(entry.has_lm, (Ks,), bool)),
            jnp.asarray(entry.R), jnp.asarray(entry.t))
        self._eng_db_n += 1

    def process_features(self, feats: Features, frame_id: int) -> FrameResult:
        """Run tracking on precomputed Features (lets tests and alternative
        frontends bypass detection)."""
        if not self.map.kf_order:
            return self._bootstrap(feats, frame_id)
        if not self.map.lm_valid.any():
            return self._two_view_init(feats, frame_id)
        return self._track(feats, frame_id)

    # ------------------------------------------------------------------

    def _store_result(self, frame_id, R, t, **kw) -> FrameResult:
        # copy=True: R/t may be views into the keyframe ring buffer, whose
        # slots get overwritten after eviction — history must not alias it
        res = FrameResult(frame_id=frame_id,
                          R=np.array(R, np.float32, copy=True),
                          t=np.array(t, np.float32, copy=True), **kw)
        self.frames.append(res)
        self._last_R = res.R
        self._last_t = res.t
        return res

    def _new_keyframe(self, feats: Features, frame_id, R, t,
                      feats_np: Optional[Features] = None):
        """feats_np: host copy of feats, if the caller already fetched one
        (one device_get of the whole pytree instead of one readback per
        array)."""
        if feats_np is None:
            feats_np = jax.device_get(feats)
        slot, _ = self.map.allocate_keyframe()
        self.map.set_keyframe(
            slot, frame_id, np.asarray(R), np.asarray(t),
            feats_np.descriptors, np.asarray(feats_np.keypoints.yx),
            np.asarray(feats_np.keypoints.valid))
        self._prev_feats = feats
        self._frames_since_kf = 0
        return slot

    def _bootstrap(self, feats, frame_id) -> FrameResult:
        R = np.eye(3, dtype=np.float32)
        t = np.zeros(3, np.float32)
        self._new_keyframe(feats, frame_id, R, t)
        return self._store_result(frame_id, R, t, is_keyframe=True)

    # ------------------------------------------------------------------

    def _two_view_init(self, feats, frame_id) -> FrameResult:
        kf = self.map.last_keyframe_slot()
        prev = self._prev_feats
        m = self._match(prev, feats)
        uv1 = prev.keypoints.yx[m.idx_a][:, ::-1]
        uv2 = feats.keypoints.yx[m.idx_b][:, ::-1]
        x1 = normalized(uv1, self.intr)
        x2 = normalized(uv2, self.intr)
        self._key, sub = jax.random.split(self._key)
        R, t, X, inl, n = self._ransac(x1, x2, m.valid, sub)
        n = int(n)
        if n < self.cfg.keyframe_min_inliers:
            # not enough parallax/matches yet; keep waiting — but if the
            # bootstrap frame itself is bad (sustained failure), re-anchor
            # the bootstrap on the current frame
            self._lost_streak += 1
            if self._lost_streak > self.max_lost_frames:
                self._recover(feats, frame_id)
            return self._store_result(frame_id, self._last_R, self._last_t,
                                      num_matches=int(m.count()),
                                      num_inliers=n, tracking_ok=False)
        self._lost_streak = 0
        # fix monocular scale: median depth of inliers -> init_depth
        X = np.asarray(X)
        inl_np = np.asarray(inl)
        depth = np.median(X[inl_np, 2])
        s = self.init_depth / max(depth, 1e-6)
        X = X * s                       # points in the FIRST keyframe's frame
        t_rel = np.asarray(t) * s
        R_rel = np.asarray(R)
        # compose with the first keyframe's (possibly non-identity after a
        # re-initialization) world pose: T2 = T_rel . T_kf1, X_w = T_kf1^-1 X
        R1 = self.map.kf_R[kf]
        t1 = self.map.kf_t[kf]
        R = R_rel @ R1
        t = R_rel @ t1 + t_rel
        X = (X - t1) @ R1

        # register landmarks + observations in both keyframes
        idx_a = np.asarray(m.idx_a)[inl_np]
        idx_b = np.asarray(m.idx_b)[inl_np]
        lm_idx = self.map.allocate_landmarks(X[inl_np])
        uv1_in = np.asarray(x1)[inl_np]
        uv2_in = np.asarray(x2)[inl_np]
        self.map.add_observations(kf, lm_idx, uv1_in)
        self.map.kf_kp_lm[kf][idx_a] = lm_idx

        slot = self._new_keyframe(feats, frame_id, R, t)
        self.map.add_observations(slot, lm_idx, uv2_in)
        self.map.kf_kp_lm[slot][idx_b] = lm_idx
        self._run_window_ba()
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(
                self.map.kf_frame_id[kf], self.map.kf_R[kf],
                self.map.kf_t[kf], prev, self.map.kf_kp_lm[kf], self.map.X)
            self.loop_closer.add_keyframe(
                frame_id, self.map.kf_R[slot], self.map.kf_t[slot], feats,
                self.map.kf_kp_lm[slot], self.map.X)
            if self.engine and self._eng_persist is not None:
                # keep the device loop-database ring aligned with the
                # host entry list (post-recovery re-init path)
                self._engine_append_host_entry(self.loop_closer.entries[-2])
                self._engine_append_host_entry(self.loop_closer.entries[-1])
        self._eng_ready = False
        res = self._store_result(frame_id, self.map.kf_R[slot],
                                 self.map.kf_t[slot],
                                 num_matches=int(m.count()), num_inliers=n,
                                 is_keyframe=True)
        self._refresh_device_cache()
        return res

    # ------------------------------------------------------------------

    def _refresh_device_cache(self) -> None:
        """Rebuild the device-side tracking caches (last-keyframe reference,
        covisible local map, pose state) from the host map. Called after any
        host mutation the fused track step must see: keyframe insertion, BA
        writeback, loop correction, checkpoint resume."""
        kf = self.map.last_keyframe_slot()
        if self.map.kf_desc[kf] is None and self._eng_persist is not None:
            # engine-made keyframe: descriptors live on device — fetch once
            # so the host path can interoperate (mixed-mode usage)
            p = self._eng_persist
            self.map.kf_desc[kf] = np.asarray(p.kf_desc)
            self.map.kf_yx[kf] = np.asarray(p.kf_yx)
            self.map.kf_kp_valid[kf] = np.asarray(p.kf_valid)
        desc = self.map.kf_desc[kf]
        kp_lm = self.map.kf_kp_lm[kf]
        self._kf_ref = KeyframeRef(
            desc=jnp.asarray(desc),
            yx=jnp.asarray(self.map.kf_yx[kf], jnp.float32),
            kp_valid=jnp.asarray(self.map.kf_kp_valid[kf]),
            kp_has_lm=jnp.asarray(kp_lm >= 0),
            R=jnp.asarray(self.map.kf_R[kf]),
            t=jnp.asarray(self.map.kf_t[kf]))
        self._lmap, self._lmap_ids = build_local_map(
            self.map, self.cfg.local_map_size, desc.shape[1], desc.dtype)
        self._state = TrackState(R=jnp.asarray(self._last_R),
                                 t=jnp.asarray(self._last_t),
                                 vel=jnp.asarray(self._vel))

    def _track(self, feats, frame_id) -> FrameResult:
        if self._kf_ref is None:
            self._refresh_device_cache()
        # pseudo-batch of one: the tracking programs index batched Features
        fb = jax.tree_util.tree_map(lambda x: x[None], feats)
        out = self._track_lite(self._lmap, fb, np.int32(0), self._state,
                               self.intr)
        self._state = TrackState(R=out.R, t=out.t, vel=out.vel)
        stats = np.asarray(out.stats)            # the one readback per frame
        bl = jax.tree_util.tree_map(lambda x: x[None], out)
        res, disp = self._commit_tracked_frame(frame_id, fb, bl, 0, stats)
        if disp == "kf":
            self._refresh_device_cache()
        return res

    def _commit_tracked_frame(self, frame_id, fb, bl, idx, stats):
        """Apply the host-side decisions for one tracked frame given its
        stats readback. bl: the batch's TrackLite pytree (leading [B]
        axis), kept on device. Returns (FrameResult, disposition):
          "ok"       plain tracked frame
          "kf"       frame promoted to keyframe (device caches NOT yet
                     refreshed — the caller does it before re-entering
                     the scan)
          "restart"  tracking-loss recovery reset the map."""
        n_match = int(stats[0])
        n_inl = int(stats[1])
        R = stats[4:13].reshape(3, 3).astype(np.float32)
        t = stats[13:16].astype(np.float32)

        ok = n_inl >= self._track_ok_min
        self._frames_since_kf += 1
        need_kf = (self._frames_since_kf >= self.cfg.keyframe_min_gap
                   and (n_inl < self.cfg.keyframe_min_inliers
                        or self._frames_since_kf >= self.cfg.keyframe_max_gap))
        self._vel = stats[16:22].astype(np.float32)

        if not ok:
            # Failure recovery (SURVEY.md §5): after a sustained loss the
            # map is unusable from here — drop it and re-bootstrap from the
            # current frame (trajectory continues dead-reckoned through the
            # gap; a fresh two-view init restarts mapping).
            self._lost_streak += 1
            if self._lost_streak > self.max_lost_frames:
                from_db = self._recover(self.features_at(fb, idx),
                                        frame_id)
                return self._store_result(
                    frame_id, self._last_R, self._last_t,
                    num_matches=n_match, num_inliers=0, is_keyframe=True,
                    tracking_ok=from_db), "restart"
        else:
            self._lost_streak = 0

        if need_kf and ok:
            self._insert_keyframe_from_track(fb, bl, idx, frame_id, R, t)
            # FrameResult and the velocity chain keep the odometry (PnP)
            # pose so the exported trajectory stays internally consistent
            # with the non-keyframe frames around it; the BA-adjusted pose
            # lives in the map (PnP re-anchors against it every frame).
            return self._store_result(frame_id, R, t, num_matches=n_match,
                                      num_inliers=n_inl, is_keyframe=True,
                                      tracking_ok=True), "kf"
        return self._store_result(frame_id, R, t,
                                  num_matches=n_match,
                                  num_inliers=n_inl, is_keyframe=False,
                                  tracking_ok=ok), "ok"

    # ------------------------------------------------------------------

    def _recover(self, feats, frame_id) -> bool:
        """Sustained-loss recovery: first try ORB-SLAM-style relocalization
        (PnP against the keyframe database via LoopCloser.relocalize) so the
        new map segment re-anchors at a map-consistent pose; fall back to
        re-bootstrapping at the dead-reckoned last pose. Returns True when
        the pose came from the database."""
        from_db = False
        if (self.engine and self._eng_persist is not None
                and self._eng_db_n > 0 and self.loop_closer is not None):
            # device-resident database: retrieval + verification on device
            from visualslam.slam.engine import decode_loop_row

            rows = np.asarray(self._eng_progs["relocalize"](
                self._eng_persist, jnp.int32(self._eng_db_n), feats,
                self.intr))
            lc = self.loop_closer
            for row in rows:
                r = decode_loop_row(row)
                if (r.cand >= 0 and r.sim >= lc.cos_thresh
                        and r.n_usable >= lc.min_inliers
                        and r.n_inl >= lc.min_inliers):
                    self._last_R = np.array(r.R, np.float32, copy=True)
                    self._last_t = np.array(r.t, np.float32, copy=True)
                    self.db_relocalizations += 1
                    from_db = True
                    break
        elif self.loop_closer is not None:
            r = self.loop_closer.relocalize(feats)
            if r is not None:
                R, t, _, _ = r
                self._last_R = np.array(R, np.float32, copy=True)
                self._last_t = np.array(t, np.float32, copy=True)
                self.db_relocalizations += 1
                from_db = True
        self._reinitialize(feats, frame_id)
        self._lost_streak = 0
        self.relocalizations += 1
        return from_db

    def _reinitialize(self, feats, frame_id) -> None:
        """Drop the map and re-bootstrap from the current frame at the last
        known pose (keeps the trajectory frame; mapping restarts)."""
        from visualslam.slam.map_state import SlamMap

        feat_cap = (self.cfg.sift.max_keypoints
                    if self.cfg.frontend == "sift"
                    else self.cfg.orb.max_keypoints)
        self.map = SlamMap(self.cfg.ba.max_cameras,
                           self.map_landmarks, feat_cap)
        self._vel = np.zeros(6, np.float32)
        self._new_keyframe(feats, frame_id, self._last_R, self._last_t)
        self._kf_ref = None     # stale until the next two-view init succeeds
        self._eng_ready = False

    def _insert_keyframe_from_track(self, fb, bl, idx, frame_id, R, t):
        """Promote frame idx to a keyframe using the batch's fused track
        outputs (bl, device-resident): tracked-landmark observations from
        the local-map association, new landmarks from the triangulated +
        gated 2D-2D matches. The only extra device readback per keyframe
        is the packed product buffer + descriptors."""
        from visualslam.slam.track_step import TrackAssoc

        # keyframe products (2D-2D match vs last keyframe, triangulation)
        # are computed only now — on the frame actually being promoted;
        # the program also returns the sliced single-frame Features so the
        # host never slices the batched pytree eagerly
        with self._stage("kf_step_dispatch"):
            packed, feats = self._kf_step(
                self._kf_ref, fb, np.int32(idx), bl, self.intr)
        # ONE 2-leaf host fetch for everything this keyframe needs (the
        # packed f32 buffer + descriptors, which keep their own dtype)
        with self._stage("kf_readback"):
            packed_np, desc_np = jax.device_get((packed, feats.descriptors))
        M = self.cfg.match.max_matches
        K = desc_np.shape[0]
        _, ai, af, kp_yx, kp_resp, kp_valid = unpack_keyframe_products(
            packed_np, M, K)
        d = TrackAssoc.unpack(ai, af)
        prev_kf = self.map.last_keyframe_slot()
        # numpy Features view for the host consumers (map storage + loop
        # database); unfetched fields stay zero
        zeros_k = np.zeros(K, np.float32)
        feats_np = Features(
            Keypoints(yx=kp_yx, yx_oct=np.zeros((K, 2), np.float32),
                      octave=np.zeros(K, np.int32),
                      level=np.zeros(K, np.int32),
                      sigma=zeros_k, orientation=zeros_k,
                      response=kp_resp, valid=kp_valid),
            desc_np)

        slot = self._new_keyframe(feats, frame_id, R, t, feats_np=feats_np)

        # 1. observations of tracked (local-map) landmarks
        lm_ids = self._lmap_ids[np.maximum(d.lm_slot, 0)]
        tracked = d.lm_valid & d.lm_inlier & (lm_ids >= 0)
        if tracked.any():
            self.map.add_observations(slot, lm_ids[tracked],
                                      d.lm_x[tracked])
            self.map.kf_kp_lm[slot][d.lm_kp[tracked]] = lm_ids[tracked]

        # 2. new landmarks: triangulation + gates already ran on device
        good = np.asarray(d.tri_good)
        if good.any():
            lm_idx = self.map.allocate_landmarks(d.tri_X[good])
            self.map.add_observations(prev_kf, lm_idx, d.m_x1[good])
            self.map.add_observations(slot, lm_idx, d.m_x2[good])
            self.map.kf_kp_lm[prev_kf][d.m_idx_a[good]] = lm_idx
            self.map.kf_kp_lm[slot][d.m_idx_b[good]] = lm_idx

        # 3. windowed BA
        if self.run_ba:
            with self._stage("window_ba"):
                self._run_window_ba()
        # refresh cached current pose from (possibly) adjusted keyframe
        self._last_R = self.map.kf_R[slot].copy()
        self._last_t = self.map.kf_t[slot].copy()

        # 4. loop closure (gets the already-fetched host copy of feats)
        if self.loop_closer is not None:
            with self._stage("loop_closure"):
                idx = self.loop_closer.add_keyframe(
                    frame_id, self.map.kf_R[slot], self.map.kf_t[slot],
                    feats_np, self.map.kf_kp_lm[slot], self.map.X)
                if self.engine and self._eng_persist is not None:
                    self._engine_append_host_entry(
                        self.loop_closer.entries[-1])
                edge = (None if idx < self._loop_cooldown_until
                        else self.loop_closer.detect(idx))
                if edge is not None:
                    self.num_loop_closures += 1
                    self._loop_cooldown_until = (
                        idx + self.cfg.loop.cooldown_keyframes)
                    self.loop_closer.optimize()
                    self._apply_loop_correction(slot, idx)

        # NOTE: the device caches are NOT refreshed here — the caller
        # decides when the new keyframe becomes visible to tracking
        # (deferred to the batch boundary in process_batch; immediate in
        # the single-frame path).
        self._eng_ready = False     # engine device state now stale

    def _apply_loop_correction(self, slot: int, db_idx: int) -> None:
        """Move the active window (poses + landmarks) so the latest keyframe
        matches its pose-graph-corrected pose.

        The loop closer provides the world-side Sim(3) correction
        G = S_corr^-1 . S_old of the latest keyframe (sg == 1 in SE(3)
        mode). Landmarks: X' = G X; window poses T' = descale(S_T . G^-1),
        which maps the last keyframe exactly onto its corrected pose while
        preserving each camera's view of the (corrected) landmarks.
        Database entries were already propagated inside optimize()."""
        lc = self.loop_closer
        if lc.last_corrections is None or db_idx >= len(lc.last_corrections):
            return
        Rg, tg, sg = lc.last_corrections[db_idx]
        Rgi, tgi, sgi = (np.asarray(a) for a in sim3.inverse(
            jnp.asarray(Rg), jnp.asarray(tg), jnp.asarray(np.float32(sg))))
        sgi = float(sgi)
        # landmarks: X' = G X = sg Rg X + tg
        live = self.map.lm_valid
        self.map.X[live] = sg * (self.map.X[live] @ Rg.T) + tg
        # window poses: S' = (R_k, t_k, 1) . G^-1, then de-scale (R', t'/s')
        for s in self.map.kf_order:
            R_k = self.map.kf_R[s]
            t_k = self.map.kf_t[s]
            self.map.kf_R[s] = R_k @ Rgi
            self.map.kf_t[s] = (R_k @ tgi + t_k) / sgi
        self._last_R = self.map.kf_R[slot].copy()
        self._last_t = self.map.kf_t[slot].copy()

    # ------------------------------------------------------------------

    def metrics(self) -> list:
        """Structured per-frame metrics (SURVEY.md §5 observability) —
        serialize as JSON lines for offline analysis."""
        out = []
        for f in self.frames:
            out.append({
                "frame": int(f.frame_id),
                "matches": int(f.num_matches),
                "inliers": int(f.num_inliers),
                "keyframe": bool(f.is_keyframe),
                "tracking_ok": bool(f.tracking_ok),
            })
        if out:
            out[-1]["landmarks"] = int(self.map.lm_valid.sum())
            out[-1]["keyframes"] = len(self.map.kf_order)
            out[-1]["loop_closures"] = self.num_loop_closures
            out[-1]["relocalizations"] = self.relocalizations
            out[-1]["db_relocalizations"] = self.db_relocalizations
            out[-1]["last_ba_cost"] = self.last_ba_cost
        return out

    last_ba_cost: float = -1.0
    _pending_ba = None      # (slots, frame_ids, lm_slots, lm_uids, nC, nL, res)

    def _run_window_ba(self, iters_scale: int = 1) -> None:
        # lazy flush: if the previous async BA hasn't finished, let it ride
        # — its writeback lands at the NEXT keyframe (the map lags one more
        # window; PnP re-anchors against the map every frame so the
        # trajectory absorbs the correction when it lands)
        self._flush_pending_ba(wait=False)
        if self._pending_ba is not None:
            return      # previous window still optimizing; skip this one
        cfg = self.cfg.ba
        if iters_scale > 1:
            cfg = cfg.replace(iters=cfg.iters * iters_scale)
        (slots, R, t, lm_slots, X, cam_idx, lm_idx, uv,
         valid) = self.map.build_ba_arrays(cfg.max_observations)
        if len(lm_slots) < 8 or valid.sum() < 24:
            return
        C = cfg.max_cameras
        L = cfg.max_landmarks
        nC = len(slots)
        nL = len(lm_slots)
        if nL > L:
            return  # window exceeds capacity; skip (shouldn't happen)
        padC = C - nC
        padL = L - nL
        p = BAProblem(
            R=jnp.asarray(np.concatenate(
                [R, np.tile(np.eye(3, dtype=np.float32), (padC, 1, 1))])),
            t=jnp.asarray(np.concatenate([t, np.zeros((padC, 3), np.float32)])),
            X=jnp.asarray(np.concatenate([X, np.zeros((padL, 3), np.float32)])),
            cam_idx=jnp.asarray(cam_idx, jnp.int32),
            lm_idx=jnp.asarray(lm_idx, jnp.int32),
            uv=jnp.asarray(uv, jnp.float32),
            obs_valid=jnp.asarray(valid),
            cam_valid=jnp.asarray(np.arange(C) < nC),
            lm_valid=jnp.asarray(np.arange(L) < nL),
        )
        if self.mesh is not None:
            # trajectory-sharded window BA over the device mesh: camera
            # blocks per device, ring Schur reduce-scatter, distributed CG
            from visualslam.parallel.traj_ba import (
                run_ba_traj_sharded, shard_problem_trajectory, unshard_traj)

            n = self.mesh.shape["shard"]
            if C % n:       # pad camera capacity to a block multiple
                extra = n - C % n
                p = p._replace(
                    R=jnp.concatenate([p.R, jnp.tile(
                        jnp.eye(3), (extra, 1, 1))]),
                    t=jnp.concatenate([p.t, jnp.zeros((extra, 3))]),
                    cam_valid=jnp.concatenate(
                        [p.cam_valid, jnp.zeros(extra, bool)]))
            sp = shard_problem_trajectory(p, n)
            dres = run_ba_traj_sharded(sp, cfg, self.mesh)
            Rn, tn, Xn = unshard_traj(dres.R, dres.t, dres.X, sp.lm_order,
                                      int(p.X.shape[0]))
            self.last_ba_cost = float(dres.cost)
            self.map.writeback_ba(slots, lm_slots, Rn[:nC], tn[:nC],
                                  Xn[:nL])
            return
        res = run_ba_packed_jit(p, cfg)     # async dispatch either way
        try:
            # start the D2H copy as soon as the solve completes on device,
            # so the flush's np.asarray does not wait for it after the
            # solve
            res.copy_to_host_async()
        except AttributeError:
            pass
        if cfg.async_ba:
            # stage overlap (PP analogue): BA computes on-device while the
            # next frames track; results land at the next keyframe (or any
            # trajectory/checkpoint consumer). Snapshot identities so slot
            # recycling between now and then can't corrupt the writeback.
            self._pending_ba = (slots, self.map.kf_frame_id[slots].copy(),
                                lm_slots, self.map.lm_uid[lm_slots].copy(),
                                nC, nL, res)
            return
        Rf, tf, Xf, cost, _ = unpack_ba_result(np.asarray(res), C, L)
        self.last_ba_cost = cost
        self.map.writeback_ba(slots, lm_slots, Rf[:nC], tf[:nC], Xf[:nL])

    def _flush_pending_ba(self, wait: bool = True) -> None:
        """Apply an in-flight async window BA. With wait=False the flush is
        skipped (kept pending) when the device program hasn't finished —
        callers that need the adjusted map (checkpoint, global BA,
        trajectory export) use wait=True."""
        if self._pending_ba is None:
            return
        slots, fids, lm_slots, uids, nC, nL, res = self._pending_ba
        if not wait:
            try:
                ready = res.is_ready()
            except AttributeError:      # non-jax.Array backends
                ready = True
            if not ready:
                return
        self._pending_ba = None
        # ONE host fetch of the packed fixed-shape buffer, sliced in numpy:
        # eager device-side slices like res.R[:nC] would compile a fresh
        # slice program per distinct window size
        Rf, tf, Xf, cost, _ = unpack_ba_result(
            np.asarray(res), self.cfg.ba.max_cameras,
            self.cfg.ba.max_landmarks)
        R, t, X = Rf[:nC], tf[:nC], Xf[:nL]
        self.last_ba_cost = cost
        # only write back entities that still hold the same keyframe /
        # landmark they held at dispatch time
        kf_ok = self.map.kf_frame_id[slots] == fids
        lm_ok = self.map.lm_uid[lm_slots] == uids
        self.map.kf_R[slots[kf_ok]] = R[kf_ok]
        self.map.kf_t[slots[kf_ok]] = t[kf_ok]
        self.map.X[lm_slots[lm_ok]] = X[lm_ok]
        # the chain pose of the newest keyframe moved; refresh device state
        last = self.map.last_keyframe_slot()
        if kf_ok.any() and slots[kf_ok][-1] == last:
            self._last_R = self.map.kf_R[last].copy()
            self._last_t = self.map.kf_t[last].copy()

    # ------------------------------------------------------------------

    def global_ba(self, mesh=None):
        """Full-sequence bundle adjustment over the ENTIRE keyframe history
        (archived + live window, slam/global_ba.py). Keyframe FrameResults
        adopt their optimized poses; frames between keyframes are carried
        rigidly by their preceding keyframe's correction. With `mesh`, the
        trajectory axis is sharded across devices."""
        from visualslam.slam.global_ba import run_global_ba

        if mesh is None:
            mesh = self.mesh
        self._flush_pending_ba()
        res = run_global_ba(self.map, self.cfg.ba, self.loop_corrections(),
                            mesh)

        by_fid = {int(f): k for k, f in enumerate(res.frame_ids)}
        carry = None     # T_kf_old^-1 . T_kf_new of the preceding keyframe
        for fr in self.frames:
            if fr.frame_id in by_fid:
                k = by_fid[fr.frame_id]
                Rn = res.R[k].astype(np.float32)
                tn = res.t[k].astype(np.float32)
                Ri = fr.R.T
                ti = -fr.R.T @ fr.t
                carry = (Ri @ Rn, Ri @ tn + ti)
                fr.R, fr.t = Rn, tn
            elif carry is not None:
                Rc, tc = carry
                fr.R, fr.t = ((fr.R @ Rc).astype(np.float32),
                              (fr.R @ tc + fr.t).astype(np.float32))
        return res

    def loop_corrections(self):
        """{frame_id: (R, t)} pose-graph-corrected keyframe poses, or None
        when no loop closure has corrected the map."""
        lc = self.loop_closer
        if lc is None or lc.corrected is None:
            return None
        return {int(e.frame_id): (np.asarray(Rc), np.asarray(tc))
                for e, (Rc, tc) in zip(lc.entries, lc.corrected)}

    def trajectory(self) -> np.ndarray:
        """[F, 3, 4] camera-to-world pose matrices (KITTI convention).

        When loop closures have run, frames AFTER the latest correction are
        already expressed in the corrected map (PnP re-anchors against it)
        but frames BEFORE it still carry pre-correction odometry — a mixed
        export would put a discontinuity at every loop. Frames up to the
        last corrected keyframe therefore adopt the pose-graph-corrected
        keyframe poses, with frames between keyframes carried rigidly by
        their preceding keyframe's correction (same carry scheme as
        global_ba)."""
        corr = None
        lc = self.loop_closer
        if lc is not None and lc.corrected is not None and lc.entries:
            corr = {int(e.frame_id): (Rc, tc)
                    for e, (Rc, tc) in zip(lc.entries, lc.corrected)}
            last_fid = max(corr)
        out = []
        carry = None
        for f in self.frames:
            R, t = f.R, f.t
            if corr is not None and f.frame_id <= last_fid:
                if f.frame_id in corr:
                    Rc, tc = corr[f.frame_id]
                    Ri, ti = R.T, -R.T @ t
                    carry = (Ri @ Rc, Ri @ tc + ti)   # T_old^-1 . T_new
                    R, t = Rc, tc
                elif carry is not None:
                    Rc2, tc2 = carry
                    R, t = R @ Rc2, R @ tc2 + t
            Rcw = R.T
            c = -R.T @ t
            out.append(np.concatenate([Rcw, c[:, None]], axis=1))
        return np.stack(out)

    def keyframe_trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """(frame_ids [K], poses [K, 3, 4]) over keyframes — pose-graph-
        corrected when loop closure has run, odometry otherwise."""
        if self.loop_closer is None or not self.loop_closer.entries:
            ids = [f.frame_id for f in self.frames if f.is_keyframe]
            poses = [p for f, p in zip(self.frames, self.trajectory())
                     if f.is_keyframe]
            return np.asarray(ids), (np.stack(poses) if poses
                                     else np.zeros((0, 3, 4)))
        lc = self.loop_closer
        if lc.corrected is None:
            pairs = [(e.R, e.t) for e in lc.entries]
        else:
            pairs = lc.corrected
        ids = np.asarray([e.frame_id for e in lc.entries])
        poses = np.stack([
            np.concatenate([R.T, (-R.T @ t)[:, None]], axis=1)
            for R, t in pairs])
        return ids, poses
