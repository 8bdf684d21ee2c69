"""Device-resident SLAM engine: a whole frame batch as ONE device program.

Round-3 measurements (benchmarks/stage_breakdown.json) put ~117 ms of host
time on every keyframe: a ~1 MB descriptor readback, a separate loop-closure
dispatch+readback, a BA flush, a device-cache re-upload — plus one extra
dispatch/readback round per keyframe because the batched track scan had to
re-enter after every promotion. Round 4 moved keyframe promotion INTO the
scanned batch program. Round 5 removes the remaining per-batch host
dependencies so the host can consume telemetry one batch LATE (lag-1
pipelining, slam/tracker.process_stream) while the device runs ahead:

  per frame   track_step_lite (local-map match + PnP + velocity model)
  on promote  (still inside the scan)
              * windowed bundle adjustment over the device-resident
                observation grid — refines the window poses and landmark
                positions BEFORE the new keyframe's triangulation gates run
                (the round-4 "in-batch promotion chaining" accuracy bug:
                the second promotion of a batch triangulated against a
                PnP-only anchor pose; now every promotion sees a
                BA-refined window, VERDICT r4 item 4)
              * re-refined current pose against the BA-adjusted local map
              * 2D-2D match vs the last keyframe + triangulation gates
                (slam/track_step.keyframe_step)
              * local-map maintenance + keyframe-reference swap
              * window-ring append + observation-grid update
              * loop database append, retrieval (cosine matvec) +
                geometric verification + Sim(3) relative-scale estimate

Everything the tracker needs between batches — pose state, velocity,
keyframe reference, local-map positions/validity, the keyframe window and
its observation grid, the loop database — chains device-to-device in
EnginePersist. The per-batch host upload (EngineDyn) is just the frame
counter base, a mid-batch re-entry index, and an (almost always empty)
landmark kill list. The packed readback ships per-frame stats, one compact
record per promotion, and the post-BA window poses + landmark positions so
the host map stays a faithful (lag-1) mirror for global BA, loop closure
pose graphs, and checkpointing.

The reference promises these stages "tied together to create a SLAM
solution" (/root/reference/README.md:24) — this module is that tie, built
so a B-frame batch costs ONE dispatch and ONE (prepaid, lag-1) readback.

Capacities (all static per compiled program): K feature slots, Kl local-map
slots, M match slots, W window cameras (cfg.ba.max_cameras), Ks loop
subsample, DBCAP loop-database entries, P = max promotions per batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from visualslam.backend.ba import BAProblem, run_ba
from visualslam.backend.pnp import refine_pose
from visualslam.geometry.camera import normalized
from visualslam.models.matching import match_features
from visualslam.models.types import Features, Keypoints
from visualslam.slam.track_step import (
    KeyframeRef,
    LocalMap,
    TrackState,
    index_features,
    keyframe_step,
    track_step_lite,
)
from visualslam.utils.config import SlamConfig

NC = 3          # loop retrieval candidates verified per promotion
LOOP_REC = 22   # per-candidate verify record:
#                 [cand, sim, usable, inl, R(9), t(3), scale, nboth,
#                  recip_inl, rot_consist_deg, trans_consist,
#                  baseline_frac]
HDR = 8         # promotion record header floats


class EnginePersist(NamedTuple):
    """Device state that lives ACROSS batches and never visits the host
    (except lag-1 telemetry mirrors and checkpoints). Shapes: K=feature
    capacity, Df=float descriptor dim, Kl=local-map slots, W=window
    cameras, Ks=loop subsample, N=DBCAP."""

    # chained tracking state
    R: jnp.ndarray           # [3, 3] world-to-camera pose state
    t: jnp.ndarray           # [3]
    vel: jnp.ndarray         # [6] constant-velocity twist
    since_kf: jnp.ndarray    # [] int32 frames since last keyframe
    # last-keyframe reference (2D-2D match source)
    kf_desc: jnp.ndarray     # [K, D] (native dtype)
    kf_yx: jnp.ndarray       # [K, 2]
    kf_valid: jnp.ndarray    # [K] bool
    kf_has_lm: jnp.ndarray   # [K] bool
    kf_R: jnp.ndarray        # [3, 3]
    kf_t: jnp.ndarray        # [3]
    # local map (device-authoritative between re-enters)
    lm_desc: jnp.ndarray     # [Kl, D]
    lm_X: jnp.ndarray        # [Kl, 3] world positions (window-BA refined)
    lm_valid: jnp.ndarray    # [Kl] bool
    lm_last: jnp.ndarray     # [Kl] int32 frame counter of last association
    lm_gen: jnp.ndarray      # [Kl] int32 allocation generation per slot
    # keyframe window ring (left-aligned: oldest at 0) + observation grid
    win_R: jnp.ndarray       # [W, 3, 3]
    win_t: jnp.ndarray       # [W, 3]
    win_valid: jnp.ndarray   # [W] bool
    win_fid: jnp.ndarray     # [W] int32 global frame id per window cam
    win_n: jnp.ndarray       # [] int32 live window size
    obs_x: jnp.ndarray       # [Kl, W, 2] normalized observations
    obs_ok: jnp.ndarray      # [Kl, W] bool
    ba_cost: jnp.ndarray     # [] f32 last in-scan window-BA cost (-1 none)
    # loop database ring
    db_n: jnp.ndarray        # [] int32 live entries
    db_g: jnp.ndarray        # [N, Df] global descriptors (L2-normalized)
    db_desc: jnp.ndarray     # [N, Ks, Df]
    db_yx: jnp.ndarray       # [N, Ks, 2]
    db_lmw: jnp.ndarray      # [N, Ks, 3] landmark snapshot per sub keypoint
    db_haslm: jnp.ndarray    # [N, Ks] bool
    db_R: jnp.ndarray        # [N, 3, 3] entry poses (pose-graph corrected)
    db_t: jnp.ndarray        # [N, 3]


class EngineDyn(NamedTuple):
    """Per-batch host upload — deliberately tiny so a batch can be
    dispatched BEFORE the previous batch's telemetry is decoded (lag-1
    pipelining): nothing here depends on the previous batch's results
    except the (rare, one-batch-late) kill list."""

    frame_base: jnp.ndarray  # [] int32 global index of batch frame 0
    start: jnp.ndarray       # [] int32 first active frame in the batch
    stop: jnp.ndarray        # [] int32 first INACTIVE frame (tail batches
    #                          are padded to the compiled batch size so the
    #                          program never recompiles for a short tail —
    #                          a 12-frame remainder cost a fresh ~60 s
    #                          engine compile inside the timed wall)
    kill: jnp.ndarray        # [Kl] bool host-invalidated slots
    kill_gen: jnp.ndarray    # [Kl] int32 generation the kill refers to


class _Carry(NamedTuple):
    p: EnginePersist
    prom_n: jnp.ndarray
    prom_buf: jnp.ndarray


def float_desc(desc: jnp.ndarray) -> jnp.ndarray:
    """Descriptors as floats: bit-packed ORB words unpack to {0,1} in the
    same bit order as np.unpackbits(view(uint8), bitorder='little') so L2
    == 2x Hamming and the loop database matches the host convention
    (slam/loop_closure._prep_features)."""
    if desc.dtype == jnp.uint32:
        bits = (desc[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
        return bits.reshape(desc.shape[0], -1).astype(jnp.float32)
    return desc.astype(jnp.float32)


def float_desc_dim(desc_dim: int, dtype) -> int:
    return desc_dim * 32 if np.dtype(dtype) == np.uint32 else desc_dim


def prom_record_size(M: int) -> int:
    return HDR + M * 7 + M * 9 + NC * LOOP_REC


def tail_size(W: int, Kl: int) -> int:
    """Floats in the per-batch telemetry tail: window poses/ids/validity +
    landmark positions/validity + the window-BA cost."""
    return W * (9 + 3 + 1 + 1) + Kl * (3 + 1) + 1


def _sub_match_cfg(cfg: SlamConfig):
    return cfg.match.replace(max_matches=cfg.loop.sub_keypoints,
                             metric="l2")


def _window_ba(p: EnginePersist, cfg: SlamConfig):
    """Bundle-adjust the device-resident window: cameras = the keyframe
    ring, landmarks = local-map slots with >=2 grid observations. Runs the
    same damped-GN Schur solver as the host path (backend/ba.py) on the
    fixed [Kl, W] observation grid — no host assembly, no dispatch.
    Returns (win_R, win_t, lm_X, cost)."""
    W = p.win_R.shape[0]
    Kl = p.lm_X.shape[0]
    obs_n = jnp.sum(p.obs_ok & p.win_valid[None, :], axis=1)     # [Kl]
    lm_ba = p.lm_valid & (obs_n >= 2)
    cam_idx = jnp.broadcast_to(
        jnp.arange(W, dtype=jnp.int32)[None, :], (Kl, W)).reshape(-1)
    lm_idx = jnp.broadcast_to(
        jnp.arange(Kl, dtype=jnp.int32)[:, None], (Kl, W)).reshape(-1)
    ov = (p.obs_ok & lm_ba[:, None] & p.win_valid[None, :]).reshape(-1)
    prob = BAProblem(
        R=p.win_R, t=p.win_t, X=p.lm_X,
        cam_idx=cam_idx, lm_idx=lm_idx,
        uv=p.obs_x.reshape(-1, 2), obs_valid=ov,
        cam_valid=p.win_valid, lm_valid=lm_ba)
    # fix_first_camera anchors window index 0 — the OLDEST keyframe (the
    # ring is left-aligned), matching the host solver's gauge. The window
    # is always small (W = ba.max_cameras <= ~16): the dense Schur solve
    # is optimal here even when the config selects the matrix-free solver
    # for sequence-scale problems (global BA re-derives its own).
    ba_cfg = (cfg.ba.replace(solver="schur_dense")
              if cfg.ba.solver == "schur_mf" else cfg.ba)
    res = run_ba(prob, ba_cfg)
    R_n, t_n, X_n = res.R, res.t, res.X
    if cfg.ba.fix_gauge_scale:
        # Monocular BA leaves the 7th gauge DoF (global scale) free: with
        # only camera 0 fixed, every solve can slide the window along the
        # scale direction by overfitting reprojection noise — one random
        # step PER PROMOTION, compounding into trajectory-scale drift
        # (measured: dolly-60 ATE doubles from iters=10 to iters=20
        # without this). Re-anchor by a similarity about camera 0's
        # center choosing s so the baseline to the newest valid camera
        # keeps its pre-solve length.
        last = jnp.clip(jnp.minimum(p.win_n, W) - 1, 0, W - 1)

        def center(R, t):
            return -jnp.einsum("...ji,...j->...i", R, t)

        c0 = center(R_n[0], t_n[0])
        d_old = jnp.linalg.norm(center(p.win_R[last], p.win_t[last])
                                - center(p.win_R[0], p.win_t[0]))
        d_new = jnp.linalg.norm(center(R_n[last], t_n[last]) - c0)
        s = jnp.where((d_new > 1e-8) & (d_old > 1e-8), d_old / d_new, 1.0)
        s = jnp.clip(s, 0.5, 2.0)
        c_all = center(R_n, t_n)                   # [W, 3]
        c_scaled = c0 + s * (c_all - c0)
        t_n = -jnp.einsum("wij,wj->wi", R_n, c_scaled)
        X_n = c0 + s * (X_n - c0)
    X = jnp.where(lm_ba[:, None], X_n, p.lm_X)
    return R_n, t_n, X, res.cost


def _verify_candidate(a_desc, a_yx, a_haslm, a_lmw,
                      b_desc, b_yx, b_haslm, b_lmw, b_R, b_t,
                      intr, sub_cfg, estimate_scale: bool,
                      a_R=None, a_t=None):
    """Geometric loop verification, fully traced: descriptor match +
    motion-only PnP of the candidate camera against the current keyframe's
    landmark snapshot (metric scale preserved — sidesteps the essential
    matrix's scale ambiguity), plus the Sim(3) relative-scale estimate
    (median pairwise-distance ratio over landmark pairs with 3D in BOTH
    keyframes, mirroring slam/loop_closure._edge_from_packed).

    With (a_R, a_t) — the current keyframe's pose — the verification is
    MUTUAL: the current camera is also PnP'd against the CANDIDATE's
    landmark snapshot (in the candidate era's frame/metric), and the two
    independently measured relative poses are compared. Single-sided PnP
    on far landmarks has a depth-ambiguous failure mode: a pose shifted
    along the viewing ray keeps tens of "inliers" while being meters off
    (measured on the KITTI-scale world: an accepted edge whose relative
    translation had the WRONG SIGN along z, ATE 19 m after the pose graph
    trusted it). The wrong local minimum is not mirrored consistently by
    the reciprocal solve, so the consistency angles expose it."""
    ks = a_desc.shape[0]
    ones = jnp.ones(ks, bool)
    fa = Features(Keypoints.empty(ks)._replace(yx=a_yx, valid=ones), a_desc)
    fb = Features(Keypoints.empty(ks)._replace(yx=b_yx, valid=ones), b_desc)
    m = match_features(fa, fb, sub_cfg)
    usable = m.valid & a_haslm[m.idx_a]
    X = a_lmw[m.idx_a]
    x_b = normalized(b_yx[m.idx_b][:, ::-1], intr)
    # coarse-to-fine: the init (the entry's stored pose) carries the full
    # era drift, so residuals start ~20x the fine Huber delta and the
    # robust weights crush the gradient — 10 fine iterations stopped with
    # 10-20 deg of rotation error that the pose graph then amplified into
    # multi-meter trajectory warps. A wide-delta stage first pulls the
    # pose into the fine stage's convergence basin.
    pr0 = refine_pose(b_R, b_t, X, x_b, usable, iters=12,
                      huber_delta=5e-2)
    pr = refine_pose(pr0.R, pr0.t, X, x_b, usable, iters=15)

    recip_inl = jnp.float32(0.0)
    rot_consist = jnp.float32(0.0)
    trans_consist = jnp.float32(0.0)
    baseline_frac = jnp.float32(0.0)
    if a_R is not None:
        usable_b = m.valid & b_haslm[m.idx_b]
        Xb = b_lmw[m.idx_b]
        x_a = normalized(a_yx[m.idx_a][:, ::-1], intr)
        # the current camera in the candidate era's frame, initialized at
        # the candidate's pose (the views overlap, so it is a good seed);
        # same coarse-to-fine schedule as the forward solve
        pr20 = refine_pose(b_R, b_t, Xb, x_a, usable_b, iters=12,
                           huber_delta=5e-2)
        pr2 = refine_pose(pr20.R, pr20.t, Xb, x_a, usable_b, iters=15)
        recip_inl = pr2.num_inliers.astype(jnp.float32)
        # relative rotation cam_b -> cam_a measured in both frames must
        # agree (relative rotations are world-frame invariant)
        rel_cur = a_R @ pr.R.T
        rel_old = pr2.R @ b_R.T
        cosang = (jnp.trace(rel_cur.T @ rel_old) - 1.0) / 2.0
        rot_consist = jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0)))
        # relative-translation agreement, expressed in cam b's own frame
        # and NORMALIZED BY SCENE DEPTH — an angular direction check is
        # pure noise at a true revisit (near-zero baseline), while the
        # depth-normalized error is exactly the parallax the disagreement
        # would induce
        c_a1 = -a_R.T @ a_t
        c_b1 = -pr.R.T @ pr.t
        c_a2 = -pr2.R.T @ pr2.t
        c_b2 = -b_R.T @ b_t
        u1 = pr.R @ (c_a1 - c_b1)
        u2 = b_R @ (c_a2 - c_b2)
        z = (X @ pr.R.T)[:, 2] + pr.t[2]
        zs = jnp.sort(jnp.where(usable, z, jnp.inf))
        n_us = jnp.sum(usable.astype(jnp.int32))
        med_z = zs[jnp.maximum(n_us - 1, 0) // 2]
        med_z = jnp.where((n_us > 0) & (med_z > 1e-3), med_z, 1e9)
        trans_consist = jnp.linalg.norm(u1 - u2) / med_z
        # baseline relative to scene depth: shared-landmark PnP degrades
        # sharply past ~0.2 — corridor-overlap matches at 0.3-0.6 produced
        # edges whose error exceeded the drift they "corrected". Take the
        # MAX of the measured and the odometry-believed separation: a
        # broken measurement under-reports its own baseline (observed: a
        # 5.6-unit-true edge claiming 2.6), but it cannot fake odometry.
        baseline_frac = jnp.maximum(
            jnp.linalg.norm(c_a1 - c_b1),
            jnp.linalg.norm(c_a1 - c_b2)) / med_z

    scale = jnp.float32(1.0)
    nboth = jnp.int32(0)
    if estimate_scale:
        both = pr.inliers & usable & b_haslm[m.idx_b]
        NS = 32
        # up to NS matched pairs with 3D on both sides (stable partition)
        sel = jnp.argsort(~both)[:NS]
        ok = both[sel]
        Xa = a_lmw[m.idx_a[sel]]
        Xb = b_lmw[m.idx_b[sel]]
        da = jnp.linalg.norm(Xa[:, None] - Xa[None, :], axis=-1)
        db = jnp.linalg.norm(Xb[:, None] - Xb[None, :], axis=-1)
        iu = jnp.triu(jnp.ones((NS, NS), bool), 1)
        pair_ok = ok[:, None] & ok[None, :] & iu & (da > 1e-6) & (db > 1e-6)
        ratio = db / jnp.maximum(da, 1e-6)
        vals = jnp.sort(jnp.where(pair_ok, ratio, jnp.inf).reshape(-1))
        n_ok = jnp.sum(pair_ok.astype(jnp.int32))
        nmax = jnp.maximum(n_ok - 1, 0)
        med = vals[nmax // 2]                              # lower median
        q1 = vals[nmax // 4]
        q3 = vals[(3 * nmax) // 4]
        nboth = jnp.sum(ok.astype(jnp.int32))
        # the estimator must VALIDATE itself: triangulation depth noise on
        # far landmarks makes pairwise-distance ratios junk (measured
        # 0.87/1.29 on edges whose true era-scale ratio was 1.10/0.93,
        # and a spurious 13% scale gradient through the Sim(3) graph warps
        # a deep trajectory by meters). Trust the median only with strong
        # support AND a tight inter-quartile spread — close-range
        # snapshots (where scale drift is actually measurable) pass, far-
        # field corridor matches snap to SE(3).
        spread_ok = (q3 - q1) <= 0.1 * jnp.maximum(med, 1e-6)
        scale = jnp.where((n_ok >= 45) & (nboth >= 10) & spread_ok,
                          jnp.clip(med, 0.2, 5.0), jnp.float32(1.0))

    f32 = jnp.float32
    return jnp.concatenate([
        jnp.stack([jnp.sum(usable.astype(f32)),
                   pr.num_inliers.astype(f32)]),
        pr.R.reshape(-1), pr.t,
        jnp.stack([scale, nboth.astype(f32),
                   recip_inl, rot_consist, trans_consist, baseline_frac]),
    ])                                                     # [19]


def _promote(c: _Carry, feats: Features, lite, i, fctr, intr,
             cfg: SlamConfig, max_depth: float, P: int, ok_min: int):
    """The in-scan keyframe promotion. Order matters for accuracy:

      1. window BA over the device observation grid (refines the previous
         keyframes and landmark positions — the triangulation anchor is
         never a raw PnP pose, VERDICT r4 item 4)
      2. re-refine the current frame's pose against the adjusted local map
      3. 2D-2D match vs the (refined) last keyframe + triangulation gates
      4. local-map maintenance, keyframe-reference swap, window append +
         observation-grid update
      5. loop database entry + retrieval + verification
    """
    p = c.p
    K = feats.capacity
    Kl = p.lm_desc.shape[0]
    M = cfg.match.max_matches
    Ks = cfg.loop.sub_keypoints
    CAP = p.db_g.shape[0]
    W = p.win_R.shape[0]

    # ---- 1. window BA (pre-promotion window) -------------------------
    win_R, win_t, lm_X, ba_cost = _window_ba(p, cfg)
    last_idx = jnp.clip(jnp.minimum(p.win_n, W) - 1, 0, W - 1)
    kf_R = win_R[last_idx]
    kf_t = win_t[last_idx]

    # ---- 2. re-refine the current pose vs the adjusted map -----------
    pr2 = refine_pose(lite.R, lite.t, lm_X[lite.ml_idx_a], lite.ml_x,
                      lite.ml_gated)
    ok2 = pr2.num_inliers >= ok_min
    R_cur = jnp.where(ok2, pr2.R, lite.R)
    t_cur = jnp.where(ok2, pr2.t, lite.t)
    inliers = jnp.where(ok2, pr2.inliers, lite.ml_inlier)
    lite = lite._replace(R=R_cur, t=t_cur, ml_inlier=inliers)

    # ---- 3. keyframe products (2D-2D match + triangulation) ----------
    kfref = KeyframeRef(desc=p.kf_desc, yx=p.kf_yx, kp_valid=p.kf_valid,
                        kp_has_lm=p.kf_has_lm, R=kf_R, t=kf_t)
    full = keyframe_step(kfref, feats, lite, intr, cfg, max_depth)
    m_idx_a = full.assoc_i[:, 3]
    m_idx_b = full.assoc_i[:, 4]
    tri_good = (full.assoc_i[:, 5] & 2) > 0
    Xw = full.assoc_f[:, 6:9]

    seen = lite.ml_gated & lite.ml_inlier                  # [M]

    # ---- 4a. local-map maintenance -----------------------------------
    # new-landmark slot allocation: invalid slots first, then oldest-seen
    key = jnp.where(p.lm_valid, p.lm_last.astype(jnp.float32), -jnp.inf)
    order = jnp.argsort(key)                               # [Kl]
    rank = jnp.cumsum(tri_good.astype(jnp.int32)) - 1
    can_alloc = tri_good & (rank < Kl)
    slot = jnp.where(can_alloc, order[jnp.clip(rank, 0, Kl - 1)], Kl)

    idx_seen_a = jnp.where(seen, lite.ml_idx_a, Kl)
    lm_desc = p.lm_desc.at[idx_seen_a].set(
        feats.descriptors[lite.ml_idx_b], mode="drop")
    lm_desc = lm_desc.at[slot].set(feats.descriptors[m_idx_b], mode="drop")
    lm_X = lm_X.at[slot].set(Xw, mode="drop")
    lm_valid = p.lm_valid.at[slot].set(True, mode="drop")
    lm_last = p.lm_last.at[slot].set(fctr, mode="drop")
    lm_gen = p.lm_gen.at[slot].add(1, mode="drop")

    # ---- 4b. keyframe-reference swap ---------------------------------
    has_lm = jnp.zeros(K, bool)
    has_lm = has_lm.at[jnp.where(seen, lite.ml_idx_b, K)].set(
        True, mode="drop")
    has_lm = has_lm.at[jnp.where(can_alloc, m_idx_b, K)].set(
        True, mode="drop")

    # landmark position per current keypoint (the loop entry's 3D snapshot)
    lmw_kp = jnp.zeros((K, 3), jnp.float32)
    lmw_kp = lmw_kp.at[jnp.where(seen, lite.ml_idx_b, K)].set(
        lm_X[lite.ml_idx_a], mode="drop")
    lmw_kp = lmw_kp.at[jnp.where(can_alloc, m_idx_b, K)].set(
        Xw, mode="drop")

    # ---- 4c. window-ring append + observation grid -------------------
    full_ring = p.win_n >= W
    roll = lambda a, ax: jnp.where(full_ring, jnp.roll(a, -1, axis=ax), a)  # noqa: E731
    win_R = roll(win_R, 0)
    win_t = roll(win_t, 0)
    win_valid = roll(p.win_valid, 0)
    win_fid = roll(p.win_fid, 0)
    obs_x = roll(p.obs_x, 1)
    obs_ok = roll(p.obs_ok, 1)
    wi = jnp.where(full_ring, W - 1, p.win_n)
    win_R = win_R.at[wi].set(R_cur)
    win_t = win_t.at[wi].set(t_cur)
    win_valid = win_valid.at[wi].set(True)
    win_fid = win_fid.at[wi].set(fctr)
    win_n = jnp.minimum(p.win_n + 1, W)
    # the appended column starts empty (after a roll it holds the evicted
    # oldest camera's wrapped observations)
    obs_ok = obs_ok.at[:, wi].set(False)
    # newly allocated slots hold brand-new landmarks: clear their rows
    obs_ok = (obs_ok & (lm_gen == p.lm_gen)[:, None])
    # tracked-landmark observations of the new keyframe
    obs_x = obs_x.at[idx_seen_a, wi].set(lite.ml_x, mode="drop")
    obs_ok = obs_ok.at[idx_seen_a, wi].set(True, mode="drop")
    # triangulated landmarks: observed by the previous keyframe (wi-1) and
    # the new one (wi); a promotion implies win_n >= 1 so wi >= 1 here
    # except at an (impossible) empty-window promotion — clip to be safe
    wprev = jnp.clip(wi - 1, 0, W - 1)
    obs_x = obs_x.at[slot, wprev].set(full.assoc_f[:, 2:4], mode="drop")
    obs_ok = obs_ok.at[slot, wprev].set(wi >= 1, mode="drop")
    obs_x = obs_x.at[slot, wi].set(full.assoc_f[:, 4:6], mode="drop")
    obs_ok = obs_ok.at[slot, wi].set(True, mode="drop")

    # ---- 5. loop database entry + retrieval --------------------------
    descF = float_desc(feats.descriptors)
    kp = feats.keypoints
    w = jnp.where(kp.valid, jnp.maximum(kp.response, 1e-6), 0.0)
    g = jnp.sum(descF * w[:, None], axis=0)
    g = g / jnp.maximum(jnp.linalg.norm(g), 1e-9)
    score = jnp.where(kp.valid, kp.response, -jnp.inf) + has_lm * 1e6
    _, sub = jax.lax.top_k(score, Ks)
    sub_desc = descF[sub]
    sub_yx = kp.yx[sub]
    sub_haslm = has_lm[sub] & kp.valid[sub]
    sub_lmw = lmw_kp[sub]

    # retrieval + verification (against the PRE-append database)
    sims = p.db_g @ g                                      # [CAP]
    elig = jnp.arange(CAP) < (p.db_n - cfg.loop.exclude_recent)
    simsm = jnp.where(elig, sims, -2.0)
    top_sims, cand = jax.lax.top_k(simsm, NC)
    sub_cfg = _sub_match_cfg(cfg)
    ver = jax.vmap(
        lambda ci: _verify_candidate(
            sub_desc, sub_yx, sub_haslm, sub_lmw,
            p.db_desc[ci], p.db_yx[ci], p.db_haslm[ci], p.db_lmw[ci],
            p.db_R[ci], p.db_t[ci], intr, sub_cfg, cfg.loop.sim3,
            a_R=R_cur, a_t=t_cur))(cand)
    loop_pack = jnp.concatenate([
        cand.astype(jnp.float32)[:, None], top_sims[:, None], ver,
    ], axis=1)                                             # [NC, LOOP_REC]

    # database append
    wr = jnp.where(p.db_n < CAP, p.db_n, CAP)
    db_g = p.db_g.at[wr].set(g, mode="drop")
    db_desc = p.db_desc.at[wr].set(sub_desc, mode="drop")
    db_yx = p.db_yx.at[wr].set(sub_yx, mode="drop")
    db_lmw = p.db_lmw.at[wr].set(sub_lmw, mode="drop")
    db_haslm = p.db_haslm.at[wr].set(sub_haslm, mode="drop")
    db_R = p.db_R.at[wr].set(R_cur, mode="drop")
    db_t = p.db_t.at[wr].set(t_cur, mode="drop")

    # ---- promotion record --------------------------------------------
    hdr = jnp.zeros(HDR, jnp.float32)
    hdr = hdr.at[0].set(i.astype(jnp.float32))
    hdr = hdr.at[1].set(full.stats[0])                     # 2D-2D count
    ai = jnp.concatenate([
        full.assoc_i.astype(jnp.float32),
        slot.astype(jnp.float32)[:, None],
    ], axis=1)                                             # [M, 7]
    rec = jnp.concatenate([
        hdr, ai.reshape(-1), full.assoc_f.reshape(-1), loop_pack.reshape(-1),
    ])
    prom_buf = c.prom_buf.at[c.prom_n].set(rec, mode="drop")

    p = p._replace(
        R=R_cur, t=t_cur,
        kf_desc=feats.descriptors, kf_yx=kp.yx, kf_valid=kp.valid,
        kf_has_lm=has_lm, kf_R=R_cur, kf_t=t_cur,
        lm_desc=lm_desc, lm_X=lm_X, lm_valid=lm_valid, lm_last=lm_last,
        lm_gen=lm_gen,
        win_R=win_R, win_t=win_t, win_valid=win_valid, win_fid=win_fid,
        win_n=win_n, obs_x=obs_x, obs_ok=obs_ok, ba_cost=ba_cost,
        db_n=jnp.minimum(p.db_n + 1, CAP),
        db_g=db_g, db_desc=db_desc, db_yx=db_yx, db_lmw=db_lmw,
        db_haslm=db_haslm, db_R=db_R, db_t=db_t)
    return _Carry(p=p, prom_n=c.prom_n + 1, prom_buf=prom_buf)


def run_engine_batch(persist: EnginePersist, dyn: EngineDyn,
                     feats_b: Features, intr: jnp.ndarray, cfg: SlamConfig,
                     ok_min: int, max_depth: float):
    """The whole-batch program. Returns (packed f32 buffer, new persist).

    packed layout: [B*24 stats][prom_n][db_n][P * prom_record_size(M)]
    [tail_size(W, Kl) telemetry tail]. stats row: the track_step_lite
    22-vector + [22] promoted + [23] spare.
    """
    B = feats_b.keypoints.yx.shape[0]
    Kl = persist.lm_desc.shape[0]
    M = cfg.match.max_matches
    W = persist.win_R.shape[0]
    P = max(1, -(-B // max(1, cfg.keyframe_min_gap)))
    PROD = prom_record_size(M)

    # host-side invalidations (lag-1): only where the generation matches —
    # a slot the device re-allocated since the host's snapshot is spared
    kill = dyn.kill & (dyn.kill_gen == persist.lm_gen)
    persist = persist._replace(lm_valid=persist.lm_valid & ~kill)

    carry0 = _Carry(p=persist, prom_n=jnp.int32(0),
                    prom_buf=jnp.zeros((P, PROD), jnp.float32))

    def step(c: _Carry, i):
        p = c.p
        feats = index_features(feats_b, i)
        active = (i >= dyn.start) & (i < dyn.stop)
        lmap = LocalMap(desc=p.lm_desc, X=p.lm_X, valid=p.lm_valid)
        lite = track_step_lite(lmap, feats, TrackState(p.R, p.t, p.vel),
                               intr, cfg, ok_min)
        w = lambda a, b: jnp.where(active, a, b)            # noqa: E731
        lite = lite._replace(
            R=w(lite.R, p.R), t=w(lite.t, p.t), vel=w(lite.vel, p.vel),
            stats=jnp.where(active, lite.stats, 0.0),
            ml_gated=lite.ml_gated & active,
            ml_inlier=lite.ml_inlier & active,
            ok=lite.ok & active)

        fctr = dyn.frame_base + i
        seen = lite.ml_gated & lite.ml_inlier
        lm_last = p.lm_last.at[jnp.where(seen, lite.ml_idx_a, Kl)].set(
            fctr, mode="drop")
        since = jnp.where(active, p.since_kf + 1, p.since_kf)
        inl = lite.stats[1]
        need_kf = (active & lite.ok & (since >= cfg.keyframe_min_gap)
                   & ((inl < cfg.keyframe_min_inliers)
                      | (since >= cfg.keyframe_max_gap))
                   & (c.prom_n < P))

        c = c._replace(p=p._replace(
            R=lite.R, t=lite.t, vel=lite.vel, lm_last=lm_last,
            since_kf=jnp.where(need_kf, 0, since)))
        c = jax.lax.cond(
            need_kf,
            lambda cc: _promote(cc, feats, lite, i, fctr, intr, cfg,
                                max_depth, P, ok_min),
            lambda cc: cc,
            c)
        # pose fields come from the carry: a promotion refines them past
        # the lite values (window BA + re-PnP)
        stats = jnp.concatenate([
            lite.stats[:4], c.p.R.reshape(-1), c.p.t, c.p.vel,
            jnp.stack([need_kf.astype(jnp.float32), jnp.float32(0.0)]),
        ])
        return c, stats

    carry, stats = jax.lax.scan(step, carry0,
                                jnp.arange(B, dtype=jnp.int32))
    p = carry.p
    packed = jnp.concatenate([
        stats.reshape(-1),
        carry.prom_n.astype(jnp.float32)[None],
        p.db_n.astype(jnp.float32)[None],
        carry.prom_buf.reshape(-1),
        # telemetry tail: post-BA window + landmark state for the host map
        p.win_R.reshape(-1), p.win_t.reshape(-1),
        p.win_fid.astype(jnp.float32), p.win_valid.astype(jnp.float32),
        p.lm_X.reshape(-1), p.lm_valid.astype(jnp.float32),
        p.ba_cost.reshape(1),
    ])
    return packed, p


def engine_relocalize(persist: EnginePersist, db_n, feats: Features,
                      intr, cfg: SlamConfig):
    """Database relocalization for an unlocalized frame (recovery path):
    retrieval WITHOUT temporal exclusion + verification of the top NC
    candidates, one packed readback. Layout: [NC, 2 + 15] rows of
    [cand, sim, verify-record]."""
    CAP = persist.db_g.shape[0]
    Ks = cfg.loop.sub_keypoints
    descF = float_desc(feats.descriptors)
    kp = feats.keypoints
    w = jnp.where(kp.valid, jnp.maximum(kp.response, 1e-6), 0.0)
    g = jnp.sum(descF * w[:, None], axis=0)
    g = g / jnp.maximum(jnp.linalg.norm(g), 1e-9)
    score = jnp.where(kp.valid, kp.response, -jnp.inf)
    _, sub = jax.lax.top_k(score, Ks)
    q_desc = descF[sub]
    q_yx = kp.yx[sub]

    sims = persist.db_g @ g
    simsm = jnp.where(jnp.arange(CAP) < db_n, sims, -2.0)
    top_sims, cand = jax.lax.top_k(simsm, NC)
    sub_cfg = _sub_match_cfg(cfg)
    # entry side carries the landmarks; the query is the camera being
    # located, initialized at the entry's (corrected) pose
    ver = jax.vmap(
        lambda ci: _verify_candidate(
            persist.db_desc[ci], persist.db_yx[ci], persist.db_haslm[ci],
            persist.db_lmw[ci],
            q_desc, q_yx, jnp.zeros(Ks, bool), jnp.zeros((Ks, 3)),
            persist.db_R[ci], persist.db_t[ci], intr, sub_cfg, False))(cand)
    return jnp.concatenate([
        cand.astype(jnp.float32)[:, None], top_sims[:, None], ver], axis=1)


def apply_correction(persist: EnginePersist, Rg, tg, sg, Rc, tc, n,
                     Rl, tl, sl):
    """Propagate pose-graph corrections into the device state without a
    host re-enter.

    Database entries k < n adopt corrected pose (Rc[k], tc[k]) and their
    landmark snapshots move by their own world-side Sim(3) G_k:
    X' = sg (X @ Rg^T) + tg (mirrors LoopCloser.optimize's propagate step).

    The live state — local-map landmarks, window poses, pose state, the
    keyframe reference — moves by the LATEST keyframe's world correction
    G_last = (Rl, tl, sl), mirroring tracker._apply_loop_correction:
    X' = sl (X @ Rl^T) + tl; poses T' = descale(T . G_last^-1)."""
    CAP = persist.db_g.shape[0]
    mask = jnp.arange(CAP) < n
    lmw = (jnp.einsum("nkd,ned->nke", persist.db_lmw, Rg)
           * sg[:, None, None] + tg[:, None, :])
    m3 = mask[:, None, None]

    # world-side Sim(3) for the live state
    Rl = jnp.asarray(Rl)
    tl = jnp.asarray(tl)
    sl = jnp.asarray(sl)
    Rli = Rl.T
    tli = -(Rl.T @ tl) / sl
    sli = 1.0 / sl

    def corr_pose(R, t):
        # T' = (R Rli, (R tli + t) / sli)
        Rn = R @ Rli
        tn = (jnp.einsum("...ij,j->...i", R, tli) + t) / sli
        return Rn, tn

    lm_X = sl * (persist.lm_X @ Rl.T) + tl
    win_R, win_t = corr_pose(persist.win_R, persist.win_t)
    R_s, t_s = corr_pose(persist.R, persist.t)
    kf_R, kf_t = corr_pose(persist.kf_R, persist.kf_t)

    return persist._replace(
        lm_X=lm_X, win_R=win_R, win_t=win_t,
        R=R_s, t=t_s, kf_R=kf_R, kf_t=kf_t,
        db_lmw=jnp.where(m3, lmw, persist.db_lmw),
        db_R=jnp.where(m3, Rc, persist.db_R),
        db_t=jnp.where(mask[:, None], tc, persist.db_t))


# ---------------------------------------------------------------------
# host-side codec + state builders
# ---------------------------------------------------------------------


class PromRecord(NamedTuple):
    """Host-decoded promotion record."""

    frame: int               # index within the batch
    n2d: int                 # 2D-2D match count vs the previous keyframe
    lm_slot: np.ndarray      # [M] local-map slot of tracked association
    lm_kp: np.ndarray        # [M] current keypoint index
    lm_obs: np.ndarray       # [M] bool gated & PnP-inlier (an observation)
    lm_x: np.ndarray         # [M, 2] normalized observation
    m_idx_a: np.ndarray      # [M] previous-keyframe keypoint
    m_idx_b: np.ndarray      # [M] current keypoint
    tri_good: np.ndarray     # [M] bool new landmark accepted
    tri_slot: np.ndarray     # [M] engine local-map slot assigned (Kl = none)
    m_x1: np.ndarray         # [M, 2]
    m_x2: np.ndarray         # [M, 2]
    tri_X: np.ndarray        # [M, 3]
    loop: np.ndarray         # [NC, LOOP_REC] retrieval+verify results


class EngineTail(NamedTuple):
    """Host-decoded telemetry tail: the post-BA window + landmark state
    the host mirrors into its map (lag-1)."""

    win_R: np.ndarray        # [W, 3, 3]
    win_t: np.ndarray        # [W, 3]
    win_fid: np.ndarray      # [W] int64
    win_valid: np.ndarray    # [W] bool
    lm_X: np.ndarray         # [Kl, 3]
    lm_valid: np.ndarray     # [Kl] bool
    ba_cost: float


def decode_packed(packed: np.ndarray, B: int, M: int, P: int,
                  W: int, Kl: int):
    """Inverse of run_engine_batch's packing. Returns
    (stats [B, 24], [PromRecord...], db_n, EngineTail)."""
    a = np.asarray(packed)
    o = B * 24
    stats = a[:o].reshape(B, 24)
    prom_n = int(a[o])
    db_n = int(a[o + 1])
    o += 2
    PROD = prom_record_size(M)
    recs = []
    for p in range(prom_n):
        r = a[o + p * PROD: o + (p + 1) * PROD]
        hdr = r[:HDR]
        ai = r[HDR: HDR + M * 7].reshape(M, 7).astype(np.int64)
        af = r[HDR + M * 7: HDR + M * 16].reshape(M, 9)
        loop = r[HDR + M * 16:].reshape(NC, LOOP_REC)
        recs.append(PromRecord(
            frame=int(hdr[0]), n2d=int(hdr[1]),
            lm_slot=ai[:, 0], lm_kp=ai[:, 1],
            lm_obs=(ai[:, 2] & 1).astype(bool) & (ai[:, 2] & 2).astype(bool),
            lm_x=af[:, 0:2],
            m_idx_a=ai[:, 3], m_idx_b=ai[:, 4],
            tri_good=(ai[:, 5] & 2).astype(bool), tri_slot=ai[:, 6],
            m_x1=af[:, 2:4], m_x2=af[:, 4:6], tri_X=af[:, 6:9],
            loop=loop))
    o += P * PROD
    win_R = a[o:o + W * 9].reshape(W, 3, 3).astype(np.float32)
    o += W * 9
    win_t = a[o:o + W * 3].reshape(W, 3).astype(np.float32)
    o += W * 3
    win_fid = a[o:o + W].astype(np.int64)
    o += W
    win_valid = a[o:o + W] > 0.5
    o += W
    lm_X = a[o:o + Kl * 3].reshape(Kl, 3).astype(np.float32)
    o += Kl * 3
    lm_valid = a[o:o + Kl] > 0.5
    o += Kl
    tail = EngineTail(win_R=win_R, win_t=win_t, win_fid=win_fid,
                      win_valid=win_valid, lm_X=lm_X, lm_valid=lm_valid,
                      ba_cost=float(a[o]))
    return stats, recs, db_n, tail


class LoopRow(NamedTuple):
    """Host-decoded loop verify row."""

    cand: int
    sim: float
    n_usable: int
    n_inl: int
    R: np.ndarray
    t: np.ndarray
    scale: float
    n_both: int
    recip_inl: int           # reciprocal-PnP inliers (0 on one-sided runs)
    rot_consist_deg: float   # relative-rotation agreement of the two PnPs
    trans_consist: float     # translation disagreement / median scene depth
    baseline_frac: float     # measured baseline / median scene depth


def decode_loop_row(row: np.ndarray) -> LoopRow:
    return LoopRow(
        int(row[0]), float(row[1]), int(row[2]), int(row[3]),
        row[4:13].reshape(3, 3).astype(np.float32),
        row[13:16].astype(np.float32), float(row[16]), int(row[17]),
        int(row[18]), float(row[19]), float(row[20]), float(row[21]))


def loop_row_accept(r: LoopRow, min_inliers: int, rot_deg: float,
                    trans_frac: float, baseline_frac: float) -> bool:
    """Mutual-verification acceptance for an engine loop row: the forward
    and reciprocal PnPs must independently support the edge (symmetric
    inlier rule — a true revisit can be landmark-poor on one side), agree
    geometrically, and come from a genuine revisit (small baseline vs
    scene depth — wide-baseline shared-landmark PnP degrades into edges
    whose error exceeds the drift they would correct). Single-sided
    inlier counts alone accept depth-ambiguous wrong minima (measured: a
    36-inlier edge whose relative translation had the wrong sign along
    z)."""
    lo = max(1, min_inliers // 2)
    return bool(
        max(r.n_inl, r.recip_inl) >= min_inliers
        and min(r.n_inl, r.recip_inl) >= lo
        and r.rot_consist_deg <= rot_deg
        and r.trans_consist <= trans_frac
        and r.baseline_frac <= baseline_frac)


def build_persist_from_host(slam_map, cfg: SlamConfig, R, t, vel,
                            since_kf: int, db_entries=None,
                            old_persist=None,
                            db_capacity: int | None = None,
                            db_count: int | None = None):
    """Assemble an EnginePersist from host state — used on engine entry
    (after bootstrap/two-view init, recovery, or checkpoint resume).

    Local map + keyframe ref + window ring + observation grid come from
    the host map (whose keyframes hold host descriptor copies at this
    point — init and recovery paths fetch them). The loop database comes
    from `old_persist` when one exists (device entries survive recovery:
    history stays usable for relocalization) else from host
    LoopCloser-style `db_entries`.

    Returns (persist, lmap_ids [Kl] global landmark slot per engine slot,
    db_n)."""
    from visualslam.slam.track_step import build_local_map

    Kl = cfg.local_map_size
    Ks = cfg.loop.sub_keypoints
    W = cfg.ba.max_cameras
    CAP = db_capacity or cfg.loop.db_capacity

    kf = slam_map.last_keyframe_slot()
    desc = slam_map.kf_desc[kf]
    if desc is None:
        raise RuntimeError(
            "engine entry needs host descriptors for the last keyframe "
            "(bootstrap/init/recovery paths fetch them)")
    K = desc.shape[0]
    Df = float_desc_dim(desc.shape[1], desc.dtype)
    lmap, ids = build_local_map(slam_map, Kl, desc.shape[1], desc.dtype)

    # window ring, left-aligned (oldest at index 0) + observation grid
    win_R = np.tile(np.eye(3, dtype=np.float32), (W, 1, 1))
    win_t = np.zeros((W, 3), np.float32)
    win_valid = np.zeros(W, bool)
    win_fid = np.zeros(W, np.int32)
    obs_x = np.zeros((Kl, W, 2), np.float32)
    obs_ok = np.zeros((Kl, W), bool)
    rev = {int(g): k for k, g in enumerate(ids) if g >= 0}
    slots = [s for s in slam_map.kf_order if slam_map.kf_valid[s]][-W:]
    for w, s in enumerate(slots):
        win_R[w] = slam_map.kf_R[s]
        win_t[w] = slam_map.kf_t[s]
        win_valid[w] = True
        win_fid[w] = int(slam_map.kf_frame_id[s])
        if s in slam_map.obs:
            lm_idx, lm_uid, uv = slam_map.obs[s]
            keep = (slam_map.lm_valid[lm_idx]
                    & (slam_map.lm_uid[lm_idx] == lm_uid))
            for g_lm, p_uv in zip(lm_idx[keep], uv[keep]):
                k = rev.get(int(g_lm))
                if k is not None:
                    obs_x[k, w] = p_uv
                    obs_ok[k, w] = True

    if old_persist is not None:
        db = (old_persist.db_g, old_persist.db_desc, old_persist.db_yx,
              old_persist.db_lmw, old_persist.db_haslm, old_persist.db_R,
              old_persist.db_t)
        db_n = None      # caller keeps its own count
        # the HOST count is authoritative at re-enter: device entries past
        # it (speculative promotions discarded by a recovery) are dropped
        # by resetting the ring write index
        db_n_dev = (jnp.int32(db_count) if db_count is not None
                    else old_persist.db_n)
    else:
        db_g = np.zeros((CAP, Df), np.float32)
        db_desc = np.zeros((CAP, Ks, Df), np.float32)
        db_yx = np.zeros((CAP, Ks, 2), np.float32)
        db_lmw = np.zeros((CAP, Ks, 3), np.float32)
        db_haslm = np.zeros((CAP, Ks), bool)
        db_R = np.tile(np.eye(3, dtype=np.float32), (CAP, 1, 1))
        db_t = np.zeros((CAP, 3), np.float32)
        n = 0
        for e in (db_entries or []):
            if n >= CAP:
                break
            if e.desc is None:
                # device-resident entry whose ring data is gone (no
                # old_persist): keep the index slot for alignment; a zero
                # global descriptor can never pass the cosine gate
                n += 1
                continue
            db_g[n] = e.global_desc
            k = min(Ks, e.desc.shape[0])
            db_desc[n, :k] = e.desc[:k]
            db_yx[n, :k] = e.yx[:k]
            db_lmw[n, :k] = e.lm_world[:k]
            db_haslm[n, :k] = e.has_lm[:k]
            db_R[n] = e.R
            db_t[n] = e.t
            n += 1
        db = tuple(jnp.asarray(x) for x in
                   (db_g, db_desc, db_yx, db_lmw, db_haslm, db_R, db_t))
        db_n = n
        db_n_dev = jnp.int32(n)

    kp_lm = slam_map.kf_kp_lm[kf]
    persist = EnginePersist(
        R=jnp.asarray(R, jnp.float32), t=jnp.asarray(t, jnp.float32),
        vel=jnp.asarray(vel, jnp.float32),
        since_kf=jnp.int32(since_kf),
        kf_desc=jnp.asarray(desc),
        kf_yx=jnp.asarray(slam_map.kf_yx[kf], jnp.float32),
        kf_valid=jnp.asarray(slam_map.kf_kp_valid[kf]),
        kf_has_lm=jnp.asarray(kp_lm[:K] >= 0),
        kf_R=jnp.asarray(slam_map.kf_R[kf]),
        kf_t=jnp.asarray(slam_map.kf_t[kf]),
        lm_desc=lmap.desc, lm_X=lmap.X, lm_valid=lmap.valid,
        lm_last=jnp.zeros(Kl, jnp.int32),
        lm_gen=jnp.zeros(Kl, jnp.int32),
        win_R=jnp.asarray(win_R), win_t=jnp.asarray(win_t),
        win_valid=jnp.asarray(win_valid), win_fid=jnp.asarray(win_fid),
        win_n=jnp.int32(len(slots)),
        obs_x=jnp.asarray(obs_x), obs_ok=jnp.asarray(obs_ok),
        ba_cost=jnp.float32(-1.0),
        db_n=db_n_dev,
        db_g=db[0], db_desc=db[1], db_yx=db[2], db_lmw=db[3],
        db_haslm=db[4], db_R=db[5], db_t=db[6])
    return persist, ids, db_n


def db_append_host(persist: EnginePersist, n, g, desc, yx, lmw, haslm,
                   R, t):
    """Append one host-assembled entry at ring index n (keeps the device
    ring aligned with LoopCloser.entries when a host-path keyframe — e.g. a
    post-recovery two-view init — lands while a device database exists)."""
    return persist._replace(
        db_g=persist.db_g.at[n].set(g, mode="drop"),
        db_desc=persist.db_desc.at[n].set(desc, mode="drop"),
        db_yx=persist.db_yx.at[n].set(yx, mode="drop"),
        db_lmw=persist.db_lmw.at[n].set(lmw, mode="drop"),
        db_haslm=persist.db_haslm.at[n].set(haslm, mode="drop"),
        db_R=persist.db_R.at[n].set(R, mode="drop"),
        db_t=persist.db_t.at[n].set(t, mode="drop"),
        db_n=jnp.maximum(persist.db_n, n + 1))


@functools.lru_cache(maxsize=32)
def engine_programs(cfg: SlamConfig, ok_min: int, max_depth: float):
    """Jitted engine entry points, shared across Tracker instances."""
    return {
        "batch": jax.jit(
            lambda persist, dyn, fb, intr: run_engine_batch(
                persist, dyn, fb, intr, cfg, ok_min, max_depth)),
        "relocalize": jax.jit(
            lambda persist, db_n, feats, intr: engine_relocalize(
                persist, db_n, feats, intr, cfg)),
        "db_correct": jax.jit(apply_correction),
        "db_append": jax.jit(db_append_host),
    }
