"""Fused per-frame tracking step — ONE jitted device program per frame.

The reference promises the stages are "tied together to create a SLAM
solution" (the reference's README.md:24). Tying them together naively makes
the host loop a dispatch storm: every se3_exp / normalize / triangulate call
issued eagerly is a separate device execution. This module fuses everything the tracker does per frame into a
single fixed-shape program:

    local-map 3D-2D matching  ->  motion-only PnP (LM)  ->  constant-velocity
    update  ->  2D-2D matching vs the last keyframe  ->  DLT triangulation +
    acceptance gates for new landmarks

so the host issues exactly one execution per frame (plus the batched
frontend) and reads back one small stats vector. Poses chain device-to-device
between frames; the full association arrays are fetched only on the ~1-in-5
frames that become keyframes.

Local-map tracking (vs last-keyframe-only): the current frame is matched
against descriptors of ALL landmarks visible in the sliding window (each
landmark carries the descriptor from its most recent observing keyframe).
This is the ORB-SLAM-style "track local map" stage — matching only the last
keyframe makes inlier counts decay monotonically as the view drifts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from visualslam.backend.pnp import refine_pose
from visualslam.geometry import se3
from visualslam.geometry.camera import normalized
from visualslam.geometry.epipolar import triangulate
from visualslam.models.matching import match_features
from visualslam.models.types import Features, Keypoints
from visualslam.utils.config import SlamConfig


class TrackState(NamedTuple):
    """Device-resident tracker state, chained frame to frame without
    host round trips."""

    R: jnp.ndarray      # [3, 3] world-to-camera of the last processed frame
    t: jnp.ndarray      # [3]
    vel: jnp.ndarray    # [6] constant-velocity twist


class KeyframeRef(NamedTuple):
    """Device-side snapshot of the last keyframe (2D-2D matching source)."""

    desc: jnp.ndarray       # [K, D]
    yx: jnp.ndarray         # [K, 2]
    kp_valid: jnp.ndarray   # [K] bool
    kp_has_lm: jnp.ndarray  # [K] bool — keypoint already has a landmark
    R: jnp.ndarray          # [3, 3]
    t: jnp.ndarray          # [3]


class LocalMap(NamedTuple):
    """Device-side covisible-landmark set (3D-2D matching source).

    Rebuilt host-side at every keyframe / BA / loop correction; the global
    landmark ids per slot stay host-side (slam/tracker.py)."""

    desc: jnp.ndarray   # [Kl, D] representative descriptor per landmark
    X: jnp.ndarray      # [Kl, 3] world positions
    valid: jnp.ndarray  # [Kl] bool


class TrackOut(NamedTuple):
    """Everything one frame produces. `stats` packs all per-frame scalars the
    host needs into a single [22] readback:
      [0] on non-keyframes (track_step_lite): local-map gated match count
          (same as [3]); on keyframes (keyframe_step): 2D-2D match count
          vs the last keyframe
      [1] PnP inlier count   [2] PnP cost
      [3] local-map gated match count   [4:13] R   [13:16] t   [16:22] vel.
    Exported metrics report stats[0] as `num_matches` — on tracked-only
    frames that is the local-map association count, not a 2D-2D count.

    The per-match association outputs are packed into TWO buffers (assoc_i,
    assoc_f) instead of 12 separate arrays: the host fetches them only at
    keyframes, and two transfers cost less than twelve. Unpack host-side
    with `TrackAssoc.unpack`."""

    R: jnp.ndarray
    t: jnp.ndarray
    vel: jnp.ndarray
    stats: jnp.ndarray       # [22] float32
    assoc_i: jnp.ndarray     # [M, 6] int32, see TrackAssoc
    assoc_f: jnp.ndarray     # [M, 9] float32, see TrackAssoc


class TrackAssoc(NamedTuple):
    """Host-side unpacked view of TrackOut.assoc_i / assoc_f.

    assoc_i columns: 0 lm_slot, 1 lm_kp, 2 lm flags (bit0 valid&gated,
    bit1 PnP inlier), 3 m_idx_a, 4 m_idx_b, 5 m flags (bit0 match valid,
    bit1 triangulation accepted).
    assoc_f columns: 0:2 lm_x, 2:4 m_x1, 4:6 m_x2, 6:9 tri_X."""

    lm_slot: np.ndarray      # [M] local-map slot
    lm_kp: np.ndarray        # [M] current keypoint index
    lm_valid: np.ndarray     # [M] bool (gated)
    lm_inlier: np.ndarray    # [M] bool PnP inlier
    lm_x: np.ndarray         # [M, 2] normalized observation
    m_idx_a: np.ndarray      # [M] keyframe keypoint
    m_idx_b: np.ndarray      # [M] current keypoint
    m_valid: np.ndarray      # [M] bool
    m_x1: np.ndarray         # [M, 2] normalized coords in keyframe
    m_x2: np.ndarray         # [M, 2] normalized coords in current frame
    tri_X: np.ndarray        # [M, 3] triangulated world points
    tri_good: np.ndarray     # [M] bool passed all acceptance gates

    @staticmethod
    def unpack(assoc_i: np.ndarray, assoc_f: np.ndarray) -> "TrackAssoc":
        ai = np.asarray(assoc_i)
        af = np.asarray(assoc_f)
        return TrackAssoc(
            lm_slot=ai[:, 0], lm_kp=ai[:, 1],
            lm_valid=(ai[:, 2] & 1).astype(bool),
            lm_inlier=(ai[:, 2] & 2).astype(bool),
            lm_x=af[:, 0:2],
            m_idx_a=ai[:, 3], m_idx_b=ai[:, 4],
            m_valid=(ai[:, 5] & 1).astype(bool),
            tri_good=(ai[:, 5] & 2).astype(bool),
            m_x1=af[:, 2:4], m_x2=af[:, 4:6], tri_X=af[:, 6:9],
        )


def index_features(fb: Features, i: jnp.ndarray) -> Features:
    """Select frame i from batched Features INSIDE a jitted program.

    Host-side `features_at` slicing dispatches one eager slice execution
    per pytree leaf (~6 per frame); traced indexing is free."""
    return jax.tree_util.tree_map(
        lambda x: jax.lax.dynamic_index_in_dim(x, i, keepdims=False), fb)


def _local_map_features(lmap: LocalMap) -> Features:
    k = lmap.desc.shape[0]
    kps = Keypoints.empty(k)._replace(valid=lmap.valid)
    return Features(kps, lmap.desc)


class TrackLite(NamedTuple):
    """Per-frame tracking result (no keyframe products). The local-map
    association stays on device; it feeds keyframe_step when the host
    promotes the frame."""

    R: jnp.ndarray
    t: jnp.ndarray
    vel: jnp.ndarray
    stats: jnp.ndarray       # [22], same layout as TrackOut.stats
    ml_idx_a: jnp.ndarray    # [M] local-map slot
    ml_idx_b: jnp.ndarray    # [M] current keypoint
    ml_gated: jnp.ndarray    # [M] bool valid & projection-gated
    ml_inlier: jnp.ndarray   # [M] bool PnP inlier
    ml_x: jnp.ndarray        # [M, 2] normalized observation
    ok: jnp.ndarray          # [] bool tracking accepted


def track_step_lite(lmap: LocalMap, feats: Features, state: TrackState,
                    intr: jnp.ndarray, cfg: SlamConfig,
                    min_inliers: int) -> TrackLite:
    """Every-frame tracking: local-map 3D-2D association + motion-only PnP
    + constant-velocity update. The keyframe products (2D-2D match vs the
    last keyframe, triangulation) live in keyframe_step — paying them per
    frame doubles the per-frame device time for outputs only ~1-in-5
    frames (keyframes) consume.

    min_inliers: PnP inliers below which the frame falls back to the
    constant-velocity prediction (host decides recovery)."""
    # ---- 1. local-map 3D-2D association ------------------------------
    ml = match_features(_local_map_features(lmap), feats, cfg.match)
    uv_l = feats.keypoints.yx[ml.idx_b][:, ::-1]
    x_l = normalized(uv_l, intr)                        # [Ml, 2]
    Xw_l = lmap.X[ml.idx_a]                             # [Ml, 3]

    # ---- 2. constant-velocity prediction + motion-only LM ------------
    dR, dt = se3.se3_exp(state.vel)
    R0 = dR @ state.R
    t0 = dR @ state.t + dt
    # spatial gate (ORB-SLAM style "track local map"): a descriptor match
    # only counts if the landmark projects near the keypoint under the
    # predicted pose — kills matches to drifted duplicates, occluded or
    # out-of-view landmarks that pure appearance matching lets through
    Xc_l = Xw_l @ R0.T + t0
    z_l = Xc_l[:, 2]
    proj_l = Xc_l[:, :2] / jnp.maximum(z_l[:, None], 1e-6)
    gate = (z_l > 1e-3) & (jnp.linalg.norm(proj_l - x_l, axis=-1)
                           < cfg.track_gate)
    ml_gated = ml.valid & gate
    pr = refine_pose(R0, t0, Xw_l, x_l, ml_gated)
    ok = pr.num_inliers >= min_inliers
    R = jnp.where(ok, pr.R, R0)
    t = jnp.where(ok, pr.t, t0)

    # ---- 3. velocity update: vel = log(T_new . T_old^-1) -------------
    Ri, ti = se3.inverse(state.R, state.t)
    Rrel, trel = se3.compose(R, t, Ri, ti)
    vel = jnp.where(ok, se3.se3_log(Rrel, trel), state.vel)

    n_gated = jnp.sum(ml_gated.astype(jnp.float32))
    stats = jnp.concatenate([
        jnp.stack([n_gated,
                   pr.num_inliers.astype(jnp.float32),
                   pr.cost,
                   n_gated]),
        R.reshape(-1), t, vel,
    ])
    return TrackLite(R=R, t=t, vel=vel, stats=stats,
                     ml_idx_a=ml.idx_a, ml_idx_b=ml.idx_b,
                     ml_gated=ml_gated, ml_inlier=pr.inliers, ml_x=x_l,
                     ok=ok)


def keyframe_step(kf: KeyframeRef, feats: Features, lite: TrackLite,
                  intr: jnp.ndarray, cfg: SlamConfig,
                  max_depth: float) -> TrackOut:
    """Keyframe products for a frame already tracked by track_step_lite:
    2D-2D match vs the last keyframe + DLT triangulation + acceptance
    gates for new landmarks. max_depth: new landmarks beyond this depth
    (in the keyframe's camera frame) are rejected."""
    R, t = lite.R, lite.t
    kf_feats = Features(
        Keypoints.empty(kf.desc.shape[0])._replace(yx=kf.yx,
                                                   valid=kf.kp_valid),
        kf.desc)
    m = match_features(kf_feats, feats, cfg.match)
    x1 = normalized(kf.yx[m.idx_a][:, ::-1], intr)
    x2 = normalized(feats.keypoints.yx[m.idx_b][:, ::-1], intr)
    # relative pose keyframe -> current
    Rki, tki = se3.inverse(kf.R, kf.t)
    Rrel2, trel2 = se3.compose(R, t, Rki, tki)
    Xc1 = triangulate(Rrel2, trel2, x1, x2)             # keyframe cam frame
    Xw = (Xc1 - kf.t) @ kf.R                            # world
    z1 = Xc1[:, 2]
    Xc2 = Xw @ R.T + t
    z2 = Xc2[:, 2]
    r1 = jnp.linalg.norm(Xc1[:, :2] / jnp.maximum(z1[:, None], 1e-6) - x1,
                         axis=1)
    r2 = jnp.linalg.norm(Xc2[:, :2] / jnp.maximum(z2[:, None], 1e-6) - x2,
                         axis=1)
    # current keypoints already associated to a landmark this frame must not
    # spawn duplicates
    assoc = jnp.zeros(feats.capacity, jnp.int32).at[lite.ml_idx_b].max(
        (lite.ml_gated & lite.ml_inlier).astype(jnp.int32)) > 0
    fresh = ~kf.kp_has_lm[m.idx_a] & ~assoc[m.idx_b]
    tri_good = (m.valid & fresh & lite.ok
                & (z1 > 1e-3) & (z2 > 1e-3) & (z1 < max_depth)
                & (r1 < 6e-3) & (r2 < 6e-3))

    stats = lite.stats.at[0].set(m.count().astype(jnp.float32))
    assoc_i = jnp.stack([
        lite.ml_idx_a, lite.ml_idx_b,
        lite.ml_gated.astype(jnp.int32)
        | (lite.ml_inlier.astype(jnp.int32) << 1),
        m.idx_a, m.idx_b,
        m.valid.astype(jnp.int32) | (tri_good.astype(jnp.int32) << 1),
    ], axis=1)
    assoc_f = jnp.concatenate([lite.ml_x, x1, x2, Xw], axis=1)
    return TrackOut(R=R, t=t, vel=lite.vel, stats=stats,
                    assoc_i=assoc_i, assoc_f=assoc_f)


def track_batch(lmap: LocalMap, feats_b: Features, start: jnp.ndarray,
                state: TrackState, intr: jnp.ndarray, cfg: SlamConfig,
                min_inliers: int):
    """Track EVERY frame of a detected batch in ONE device program: a
    lax.scan over frames with the pose state chained inside the scan.
    Replaces B separate track_step_lite dispatches per batch — the
    single program gives XLA the whole batch to schedule.

    Frames with index < start pass the state through unchanged (zeroed
    stats): a mid-batch restart re-dispatches the SAME compiled program
    with a new start index instead of compiling per suffix length.

    Returns (final TrackState, TrackLite-of-batches: every leaf gains a
    leading [B] axis)."""
    B = feats_b.keypoints.yx.shape[0]

    def step(st, i):
        feats = index_features(feats_b, i)
        lite = track_step_lite(lmap, feats, st, intr, cfg, min_inliers)
        active = i >= start
        w = lambda a, b: jnp.where(active, a, b)     # noqa: E731
        new_st = TrackState(R=w(lite.R, st.R), t=w(lite.t, st.t),
                            vel=w(lite.vel, st.vel))
        out = TrackLite(
            R=new_st.R, t=new_st.t, vel=new_st.vel,
            stats=jnp.where(active, lite.stats, 0.0),
            ml_idx_a=lite.ml_idx_a, ml_idx_b=lite.ml_idx_b,
            ml_gated=lite.ml_gated & active,
            ml_inlier=lite.ml_inlier & active,
            ml_x=lite.ml_x,
            ok=lite.ok & active)
        return new_st, out

    final_st, outs = jax.lax.scan(step, state,
                                  jnp.arange(B, dtype=jnp.int32))
    return final_st, outs


def lite_at(batch_lite: TrackLite, i: jnp.ndarray) -> TrackLite:
    """Select frame i's TrackLite from a track_batch result (traced)."""
    return jax.tree_util.tree_map(
        lambda x: jax.lax.dynamic_index_in_dim(x, i, keepdims=False),
        batch_lite)


def pack_keyframe_products(full: TrackOut, feats: Features) -> jnp.ndarray:
    """Pack every scalar/index/coordinate a keyframe promotion fetches into
    ONE f32 device buffer: the keyframe readback is 2 transfers instead
    of 11 (this buffer + the descriptor array, which keeps its own dtype).

    Layout: [22 stats][M*6 assoc_i][M*9 assoc_f][K*2 yx][K response]
    [K valid]. assoc_i values are indices < 2^24 and 2-bit flags, exactly
    representable in f32."""
    kp = feats.keypoints
    return jnp.concatenate([
        full.stats,
        full.assoc_i.astype(jnp.float32).reshape(-1),
        full.assoc_f.reshape(-1),
        kp.yx.reshape(-1),
        kp.response,
        kp.valid.astype(jnp.float32),
    ])


def unpack_keyframe_products(packed: np.ndarray, M: int, K: int):
    """Host-side inverse of pack_keyframe_products. Returns
    (stats[22], assoc_i[M,6] int, assoc_f[M,9], yx[K,2], response[K],
    valid[K] bool)."""
    a = np.asarray(packed)
    o = 22
    stats = a[:o]
    ai = a[o:o + M * 6].reshape(M, 6).astype(np.int64)
    o += M * 6
    af = a[o:o + M * 9].reshape(M, 9)
    o += M * 9
    yx = a[o:o + K * 2].reshape(K, 2)
    o += K * 2
    resp = a[o:o + K]
    o += K
    valid = a[o:o + K] > 0.5
    return stats, ai, af, yx, resp, valid


def track_step(kf: KeyframeRef, lmap: LocalMap, feats: Features,
               state: TrackState, intr: jnp.ndarray, cfg: SlamConfig,
               min_inliers: int, max_depth: float) -> TrackOut:
    """One frame of tracking as a single traceable program — the
    composition of track_step_lite + keyframe_step (kept for callers that
    want everything in one dispatch, e.g. the multichip dryrun)."""
    lite = track_step_lite(lmap, feats, state, intr, cfg, min_inliers)
    return keyframe_step(kf, feats, lite, intr, cfg, max_depth)


track_step_jit = jax.jit(track_step, static_argnums=(5, 6, 7))


def build_local_map(slam_map, capacity: int, desc_dim: int,
                    desc_dtype) -> tuple[LocalMap, np.ndarray]:
    """Host-side rebuild of the covisible-landmark set from the sliding
    window. For each landmark observed in the window, take the descriptor of
    its MOST RECENT observing keyframe (viewpoint closest to the current
    frame). Returns (LocalMap device arrays, global landmark ids [Kl])."""
    desc = np.zeros((capacity, desc_dim), desc_dtype)
    X = np.zeros((capacity, 3), np.float32)
    ids = np.full(capacity, -1, np.int64)
    n = 0
    claimed = np.zeros(slam_map.max_landmarks, bool)
    for s in reversed(slam_map.kf_order):            # newest first
        kp_lm = slam_map.kf_kp_lm[s]
        if slam_map.kf_desc[s] is None:
            continue
        sel = np.nonzero(kp_lm >= 0)[0]
        if sel.size == 0:
            continue
        lms = kp_lm[sel]
        keep = slam_map.lm_valid[lms] & ~claimed[lms]
        sel, lms = sel[keep], lms[keep]
        # first occurrence per landmark within this keyframe
        lms, first = np.unique(lms, return_index=True)
        sel = sel[first]
        claimed[lms] = True
        take = min(len(lms), capacity - n)
        d_s = np.asarray(slam_map.kf_desc[s])
        desc[n:n + take] = d_s[sel[:take]]
        ids[n:n + take] = lms[:take]
        n += take
        if n >= capacity:
            break
    live = ids >= 0
    X[live] = slam_map.X[ids[live]]
    lmap = LocalMap(desc=jnp.asarray(desc), X=jnp.asarray(X),
                    valid=jnp.asarray(live))
    return lmap, ids
