"""Loop-closure detection + pose-graph correction.

The reference's README promises "ultimately these steps are tied together to
create a SLAM solution" (README.md:24) — loop closure is the piece that makes
the tie-together global. Design (fixed shapes per call):

  retrieval   every keyframe stores a GLOBAL descriptor (response-weighted
              mean of its local descriptors, L2-normalized). Candidates =
              argmax cosine against all past keyframes outside a temporal
              exclusion window — one [1, D] x [D, N] matvec.
  verify      full local-descriptor matching (ratio+mutual, the standard
              matcher) + PnP: the current keyframe's tracked landmarks give
              3D points; the candidate's matched keypoints give 2D rays ->
              motion-only LM yields the candidate camera's pose in the
              CURRENT world frame, metric scale included (this sidesteps the
              essential matrix's scale ambiguity for monocular loops).
  correct     a pose graph over the full keyframe history: odometry edges
              between consecutive keyframes + accepted loop edges, optimized
              with backend/pose_graph; the correction of the latest keyframe
              is applied to the active window (poses + landmarks).

              Two graph flavors (LoopConfig.sim3): SE(3) (rigid, 6-DoF) and
              Sim(3) (7-DoF, Strasdat-style) — monocular scale DRIFTS along
              the trajectory, so a revisit generally disagrees in scale too;
              the Sim(3) edge carries the relative scale measured from
              matched landmark snapshots (median pairwise-distance ratio)
              and the graph distributes the scale error over the loop.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from visualslam.backend.pnp import refine_pose_jit
from visualslam.backend.pose_graph import (
    PoseGraph,
    Sim3Graph,
    optimize_pose_graph_jit,
    optimize_sim3_graph_jit,
)

from visualslam.models.matching import match_features
from visualslam.models.types import Features, Keypoints
from visualslam.utils.config import MatchConfig, PoseGraphConfig


@dataclass
class LoopEdge:
    i: int                  # earlier keyframe index (db order)
    j: int                  # later keyframe index
    R: np.ndarray           # relative pose: T_i^-1 T_j (graph convention)
    t: np.ndarray
    num_inliers: int = 0
    scale: float = 1.0      # relative scale of the measurement (Sim(3) sm)
    rot_sigma_deg: float = 2.0  # measurement uncertainty estimate (the
    #                             mutual-PnP rotation disagreement, engine
    #                             path); drives the information weighting
    #                             in optimize()


@dataclass
class KeyframeEntry:
    frame_id: int
    R: np.ndarray           # world-to-camera at insertion (odometry frame)
    t: np.ndarray
    global_desc: np.ndarray  # [D] (None for device-resident entries)
    desc: np.ndarray        # [Ks, D] subsampled local descriptors (or None:
    #                         engine mode keeps them on device, engine.py)
    yx: np.ndarray          # [Ks, 2]
    lm_world: np.ndarray    # [Ks, 3] associated landmark positions
    has_lm: np.ndarray      # [Ks] bool


@functools.lru_cache(maxsize=32)
def _shared_matcher(match_cfg: MatchConfig):
    return jax.jit(lambda fa, fb: match_features(fa, fb, match_cfg))


@functools.lru_cache(maxsize=32)
def _shared_verifier(match_cfg: MatchConfig):
    """Fused geometric verification: match + usability gate + PnP in ONE
    device program returning ONE packed f32 buffer, so the two-sync
    seven-leaf verify path becomes one dispatch + one readback.

    Packed layout: [1 num_inliers][9 R][3 t][M usable][M idx_a][M idx_b]
    [M pnp_inliers]."""
    from visualslam.backend.pnp import refine_pose

    def verify(desc_a, yx_a, has_lm_a, lm_world_a, desc_b, yx_b,
               R0, t0, intr):
        k = desc_a.shape[0]
        ones = jnp.ones(k, bool)
        fa = Features(Keypoints.empty(k)._replace(yx=yx_a, valid=ones),
                      desc_a)
        fb = Features(Keypoints.empty(k)._replace(yx=yx_b, valid=ones),
                      desc_b)
        m = match_features(fa, fb, match_cfg)
        usable = m.valid & has_lm_a[m.idx_a]
        X = lm_world_a[m.idx_a]
        fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
        uv_b = yx_b[m.idx_b][:, ::-1]
        x_b = jnp.stack([(uv_b[:, 0] - cx) / fx, (uv_b[:, 1] - cy) / fy],
                        axis=-1)
        pr = refine_pose(R0, t0, X, x_b, usable)
        f32 = jnp.float32
        return jnp.concatenate([
            pr.num_inliers.astype(f32)[None],
            pr.R.reshape(-1), pr.t,
            usable.astype(f32), m.idx_a.astype(f32), m.idx_b.astype(f32),
            pr.inliers.astype(f32)])

    return jax.jit(verify)


@functools.lru_cache(maxsize=32)
def _shared_verifier_batch(match_cfg: MatchConfig):
    """vmapped _shared_verifier over the CANDIDATE axis: all top-k
    retrieval candidates verify in ONE dispatch + ONE packed readback
    instead of one dispatch and readback per candidate)."""
    inner = _shared_verifier(match_cfg)

    def verify_many(desc_a, yx_a, has_lm_a, lm_world_a,
                    descs_b, yxs_b, Rs_b, ts_b, intr):
        return jax.vmap(
            lambda db, yb, Rb, tb: inner(desc_a, yx_a, has_lm_a,
                                         lm_world_a, db, yb, Rb, tb, intr)
        )(descs_b, yxs_b, Rs_b, ts_b)

    return jax.jit(verify_many)


def _unpack_verify(packed: np.ndarray, M: int):
    a = np.asarray(packed)
    n_inl = int(a[0])
    R = a[1:10].reshape(3, 3)
    t = a[10:13]
    o = 13
    usable = a[o:o + M] > 0.5
    ia = a[o + M:o + 2 * M].astype(np.int64)
    ib = a[o + 2 * M:o + 3 * M].astype(np.int64)
    inl = a[o + 3 * M:o + 4 * M] > 0.5
    return n_inl, R, t, usable, ia, ib, inl


def _np_se3_relative(Ra, ta, Rb, tb):
    """T_a^-1 . T_b in plain numpy (host-side graph assembly must not pay a
    device dispatch per edge)."""
    return Ra.T @ Rb, Ra.T @ (tb - ta)


def _np_sim3_inverse(R, t, s):
    Rt = R.T
    return Rt, -(Rt @ t) / s, 1.0 / s


def _np_sim3_compose(Ra, ta, sa, Rb, tb, sb):
    return Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb


class LoopCloser:
    """Keyframe database + loop detection + pose-graph correction."""

    def __init__(self, intrinsics, match_cfg: MatchConfig,
                 pg_cfg: PoseGraphConfig,
                 sub_keypoints: int = 256,
                 cosine_threshold: float = 0.85,
                 min_inliers: int = 25,
                 exclude_recent: int = 10,
                 use_sim3: bool = False,
                 max_scale: float = 1.5):
        self.intr = np.asarray(intrinsics, np.float32)
        # entries always store float descriptors (ORB bits get unpacked to
        # {0,1} floats, where L2 == 2x Hamming), so match on L2 regardless
        # of the tracker's metric
        self.match_cfg = match_cfg.replace(max_matches=sub_keypoints,
                                           metric="l2")
        # jitted matcher: eagerly-traced match_features is dozens of
        # per-op dispatches per verification; shared
        # across instances so fresh LoopClosers don't recompile
        self._match = _shared_matcher(self.match_cfg)
        self._verifier = _shared_verifier(self.match_cfg)
        self._verifier_batch = _shared_verifier_batch(self.match_cfg)
        self.pg_cfg = pg_cfg
        self.sub = sub_keypoints
        self.cos_thresh = cosine_threshold
        self.min_inliers = min_inliers
        self.exclude = exclude_recent
        self.use_sim3 = use_sim3
        # Sim(3) scale-ratio sanity gate: the pairwise-distance-ratio
        # estimator is noisy when the snapshots share few 3D landmarks,
        # and a wrong-scale warp of the live map is far more destructive
        # than a missing scale correction (measured: a 1.29-scale edge on
        # the KITTI-scale loop world killed tracking within 3 batches).
        # Estimates outside [1/max_scale, max_scale] fall back to SE(3).
        self.max_scale = max_scale
        self.entries: List[KeyframeEntry] = []
        self.loop_edges: List[LoopEdge] = []
        # optimized poses (filled by optimize); None until first loop.
        # corrected: de-scaled SE(3) (R, t) per entry;
        # corrected_scale: per-entry Sim(3) node scale (1.0 in SE(3) mode);
        # last_corrections: per-entry world-side Sim(3) (Rg, tg, sg) mapping
        # pre-correction world points to post-correction world points.
        self.corrected: Optional[list] = None
        self.corrected_scale: Optional[list] = None
        self.last_corrections: Optional[list] = None
        self._verify_warmed = False

    def warm_verify(self, desc_dim: int = 128) -> None:
        """Compile the verification programs (matcher + PnP at the database
        shapes) ahead of the first real candidate — the first verification
        otherwise stalls the tracking loop for seconds of
        compilation, which only fires once the database outgrows the
        temporal exclusion window (deep into a run)."""
        if self._verify_warmed:
            return
        self._verify_warmed = True
        k = self.sub
        kps = Keypoints.empty(k)._replace(yx=jnp.zeros((k, 2)),
                                          valid=jnp.ones(k, bool))
        f = Features(kps, jnp.zeros((k, desc_dim), jnp.float32))
        m = self._match(f, f)
        refine_pose_jit(jnp.eye(3), jnp.zeros(3),
                        jnp.zeros((k, 3)), jnp.zeros((k, 2)),
                        jnp.zeros(k, bool))
        z = jnp.zeros
        packed = self._verifier(
            z((k, desc_dim), jnp.float32), z((k, 2)), jnp.ones(k, bool),
            z((k, 3)), z((k, desc_dim), jnp.float32), z((k, 2)),
            jnp.eye(3), z(3), jnp.ones(4, jnp.float32))
        packed_b = self._verifier_batch(
            z((k, desc_dim), jnp.float32), z((k, 2)), jnp.ones(k, bool),
            z((k, 3)), z((3, k, desc_dim), jnp.float32), z((3, k, 2)),
            jnp.tile(jnp.eye(3), (3, 1, 1)), z((3, 3)),
            jnp.ones(4, jnp.float32))
        jax.block_until_ready((m.valid, packed, packed_b))

    # ------------------------------------------------------------------

    @staticmethod
    def global_descriptor(desc: np.ndarray, response: np.ndarray,
                          valid: np.ndarray) -> np.ndarray:
        w = np.where(valid, np.maximum(response, 1e-6), 0.0)
        g = (desc * w[:, None]).sum(0)
        n = np.linalg.norm(g)
        return (g / n if n > 1e-9 else g).astype(np.float32)

    @staticmethod
    def _prep_features(feats: Features):
        """(desc, valid, resp, yx) as float numpy arrays; bit-packed ORB
        descriptors get unpacked to {0,1} floats (L2 on bit vectors ==
        2x Hamming, so the standard matcher applies unchanged)."""
        # one batched host fetch instead of one per array
        feats = jax.device_get(feats)
        desc = np.asarray(feats.descriptors)
        if desc.dtype == np.uint32:
            desc = np.unpackbits(
                desc.view(np.uint8), bitorder="little").reshape(
                desc.shape[0], -1).astype(np.float32)
        else:
            desc = desc.astype(np.float32)
        return (desc, np.asarray(feats.keypoints.valid),
                np.asarray(feats.keypoints.response),
                np.asarray(feats.keypoints.yx))

    def add_keyframe(self, frame_id: int, R, t, feats: Features,
                     kp_lm: np.ndarray, lm_positions: np.ndarray) -> int:
        """Register a keyframe. kp_lm: [K] landmark index per keypoint (-1
        if none); lm_positions: the global landmark array to snapshot from.
        Returns the database index."""
        desc, valid, resp, yx = self._prep_features(feats)
        self.warm_verify(desc.shape[1])
        # Landmark-bearing keypoints FIRST (then by response): geometric
        # verification PnPs against the entry's landmarks, and a pure
        # response-ranked subsample leaves only ~10-20% of slots with a
        # landmark — verification then can't reach min_inliers usable
        # matches even on a perfect revisit (measured: loop trajectory,
        # retrieval sims 0.99+, usable 1-6 of 256).
        score = np.where(valid, resp, -np.inf) + np.where(
            kp_lm >= 0, 1e6, 0.0)
        order = np.argsort(-score)[: self.sub]
        has_lm = kp_lm[order] >= 0
        entry = KeyframeEntry(
            frame_id=frame_id,
            R=np.array(R, np.float32, copy=True),
            t=np.array(t, np.float32, copy=True),
            global_desc=self.global_descriptor(desc, resp, valid),
            desc=desc[order].copy(),
            yx=yx[order].copy(),
            lm_world=lm_positions[np.maximum(kp_lm[order], 0)].astype(
                np.float32),
            has_lm=has_lm & valid[order],
        )
        self.entries.append(entry)
        return len(self.entries) - 1

    def add_keyframe_light(self, frame_id: int, R, t) -> int:
        """Register a keyframe whose descriptors/landmark snapshot live in
        the DEVICE database (slam/engine.py): only the pose-graph-relevant
        pose is mirrored host-side. Entry indices stay aligned 1:1 with the
        device ring."""
        self.entries.append(KeyframeEntry(
            frame_id=frame_id,
            R=np.array(R, np.float32, copy=True),
            t=np.array(t, np.float32, copy=True),
            global_desc=None, desc=None, yx=None,
            lm_world=None, has_lm=None))
        return len(self.entries) - 1

    def add_device_edge(self, i: int, j: int, Rb: np.ndarray,
                        tb: np.ndarray, num_inliers: int,
                        s_oc: float,
                        rot_sigma_deg: float = 2.0) -> LoopEdge:
        """Accept a loop edge whose geometric verification ran on device
        (engine promotion branch): (Rb, tb) is candidate camera i's pose in
        the CURRENT world frame from PnP against keyframe j's landmarks,
        s_oc the device-estimated old/current metric ratio. Composes the
        same Sim(3) measurement as _edge_from_packed."""
        a = self.entries[j]
        s = float(s_oc) if self.use_sim3 else 1.0
        if not (1.0 / self.max_scale <= s <= self.max_scale):
            s = 1.0             # distrust the ratio estimate; keep SE(3)
        Rm, tm, sm = _np_sim3_compose(
            *_np_sim3_inverse(Rb, s * tb, s), a.R, a.t, 1.0)
        edge = LoopEdge(i=i, j=j, R=np.asarray(Rm), t=np.asarray(tm),
                        num_inliers=num_inliers, scale=float(sm),
                        rot_sigma_deg=max(0.5, float(rot_sigma_deg)))
        self.loop_edges.append(edge)
        return edge

    # ------------------------------------------------------------------

    def detect(self, j: int, top_k: int = 3) -> Optional[LoopEdge]:
        """Try to close a loop for keyframe j against the database.

        Geometric verification runs over the top-k retrieval candidates
        above the cosine gate (argmax-only retrieval misses loops whenever
        the best-scoring candidate fails PnP but the runner-up would pass,
        e.g. under perceptual aliasing)."""
        n = len(self.entries)
        if j != n - 1 or n <= self.exclude + 1:
            return None
        cur = self.entries[j]
        if cur.global_desc is None:
            return None     # device-resident entry: the engine detects
        past = np.stack([
            e.global_desc if e.global_desc is not None
            else np.zeros_like(cur.global_desc)
            for e in self.entries[: n - self.exclude - 1]])
        sims = past @ cur.global_desc
        order = [int(i) for i in np.argsort(-sims)[: top_k]
                 if sims[i] >= self.cos_thresh
                 and self.entries[i].desc is not None]
        if not order:
            return None
        # all surviving candidates verify in ONE dispatch + readback
        # (pad by repeating the first so the program shape is fixed)
        cands = (order + [order[0]] * top_k)[: top_k]
        a = self.entries[j]
        packed = self._verifier_batch(
            jnp.asarray(a.desc), jnp.asarray(a.yx), jnp.asarray(a.has_lm),
            jnp.asarray(a.lm_world),
            jnp.asarray(np.stack([self.entries[i].desc for i in cands])),
            jnp.asarray(np.stack([self.entries[i].yx for i in cands])),
            jnp.asarray(np.stack([self.entries[i].R for i in cands])),
            jnp.asarray(np.stack([self.entries[i].t for i in cands])),
            jnp.asarray(self.intr, jnp.float32))
        packed_np = np.asarray(packed)
        for k, i in enumerate(order):
            edge = self._edge_from_packed(i, j, packed_np[k])
            if edge is not None:
                self.loop_edges.append(edge)
                return edge
        return None

    def _verify(self, i: int, j: int) -> Optional[LoopEdge]:
        """Geometric verification: match + PnP of candidate i against the
        current keyframe j's landmarks (metric scale preserved). One fused
        device program, one packed readback (_shared_verifier)."""
        a = self.entries[j]   # current (has fresh landmarks)
        b = self.entries[i]   # candidate

        packed = self._verifier(
            jnp.asarray(a.desc), jnp.asarray(a.yx), jnp.asarray(a.has_lm),
            jnp.asarray(a.lm_world), jnp.asarray(b.desc), jnp.asarray(b.yx),
            jnp.asarray(b.R), jnp.asarray(b.t),
            jnp.asarray(self.intr, jnp.float32))
        return self._edge_from_packed(i, j, np.asarray(packed))

    def _edge_from_packed(self, i: int, j: int,
                          packed: np.ndarray) -> Optional[LoopEdge]:
        """Interpret one fused-verifier result; returns the accepted edge
        or None."""
        a = self.entries[j]
        b = self.entries[i]
        M = self.match_cfg.max_matches
        n_inl, Rb, tb, usable, ia, ib, pr_inl = _unpack_verify(packed, M)
        if usable.sum() < self.min_inliers or n_inl < self.min_inliers:
            return None
        # candidate camera i's pose in the CURRENT world frame (PnP against
        # j's landmarks -> current metric)

        # Relative scale of i's era vs the current map: matched landmark
        # pairs seen with 3D in BOTH keyframes give the same physical
        # structure in both metrics; the median pairwise-distance ratio is a
        # robust estimate of s_oc = (old units) / (current units). Restrict
        # to PnP inliers so mismatches can't poison the median.
        inl = np.asarray(pr_inl)
        s_oc = 1.0
        if self.use_sim3:
            both = inl & a.has_lm[ia] & b.has_lm[ib]
            Xa = a.lm_world[ia[both]]
            Xb = b.lm_world[ib[both]]
            # self-validating estimator (see engine._verify_candidate):
            # trust the median pairwise ratio only with decent support AND
            # a tight inter-quartile spread — depth noise on far landmarks
            # makes the ratios junk, and a spurious Sim(3) scale gradient
            # warps deep trajectories by meters
            if Xa.shape[0] >= 10:
                n = min(Xa.shape[0], 64)
                da = np.linalg.norm(Xa[:n, None] - Xa[None, :n], axis=-1)
                db = np.linalg.norm(Xb[:n, None] - Xb[None, :n], axis=-1)
                iu = np.triu_indices(n, 1)
                da, db = da[iu], db[iu]
                ok = (da > 1e-6) & (db > 1e-6)
                if ok.sum() >= 45:
                    r = db[ok] / da[ok]
                    med = float(np.median(r))
                    q1, q3 = np.percentile(r, [25, 75])
                    if (q3 - q1) <= 0.1 * max(med, 1e-6):
                        s_oc = float(np.clip(med, 0.2, 5.0))
        if not (1.0 / self.max_scale <= s_oc <= self.max_scale):
            s_oc = 1.0          # distrust the ratio estimate; keep SE(3)

        # Graph convention (backend/pose_graph): measurement = T_i^-1 T_j
        # evaluated at consistent poses. In the current metric,
        # S_i = (Rb, s_oc*tb, s_oc) maps current world -> cam_i in i's OLD
        # units; S_j = (a.R, a.t, 1). Sm = S_i^-1 S_j (relative scale
        # 1/s_oc). In SE(3) mode s_oc == 1 and this reduces to T_i^-1 T_j.
        # Plain numpy: 3x3 algebra per edge is cheaper on the host than a
        # device dispatch.
        Rm, tm, sm = _np_sim3_compose(
            *_np_sim3_inverse(Rb, s_oc * tb, s_oc), a.R, a.t, 1.0)
        return LoopEdge(i=i, j=j, R=np.asarray(Rm), t=np.asarray(tm),
                        num_inliers=n_inl, scale=float(sm))

    # ------------------------------------------------------------------

    def relocalize(self, feats: Features, top_k: int = 3,
                   cosine_threshold: Optional[float] = None
                   ) -> Optional[tuple]:
        """Recover the camera pose of an UNLOCALIZED frame from the keyframe
        database: global-descriptor retrieval (no temporal exclusion — any
        entry may match) -> local matching -> PnP against the candidate's
        landmark snapshot (kept fresh by optimize()'s propagation). The
        ORB-SLAM-style relocalization the tracker falls back to after
        sustained tracking loss, instead of re-anchoring dead-reckoned.

        Returns (R, t, num_inliers, db_index) in the current world frame,
        or None if no candidate verifies."""
        if not self.entries:
            return None
        desc, valid, resp, yx = self._prep_features(feats)
        g = self.global_descriptor(desc, resp, valid)
        # device-resident (light) entries can't be matched host-side; the
        # engine uses engine_relocalize for those (slam/engine.py)
        sims = np.stack([
            e.global_desc if e.global_desc is not None
            else np.zeros_like(g)
            for e in self.entries]) @ g
        thresh = (self.cos_thresh if cosine_threshold is None
                  else cosine_threshold)

        # query keypoints subsampled exactly like database entries
        order_kp = np.argsort(np.where(valid, -resp, np.inf))[: self.sub]
        q_desc = desc[order_kp]
        q_yx = yx[order_kp]
        q_desc_j = jnp.asarray(q_desc)
        q_yx_j = jnp.asarray(q_yx, jnp.float32)
        for i in np.argsort(-sims)[: top_k]:
            if sims[i] < thresh:
                break
            e = self.entries[i]
            # fused match+PnP, one packed readback; entry side has the
            # landmarks, the query is the camera being located, initialized
            # at the entry's (corrected) pose — the query viewpoint is near
            # it by construction of the retrieval
            packed = self._verifier(
                jnp.asarray(e.desc), jnp.asarray(e.yx),
                jnp.asarray(e.has_lm), jnp.asarray(e.lm_world),
                q_desc_j, q_yx_j,
                jnp.asarray(e.R), jnp.asarray(e.t),
                jnp.asarray(self.intr, jnp.float32))
            n_inl, Rq, tq, usable, _, _, _ = _unpack_verify(
                packed, self.match_cfg.max_matches)
            if usable.sum() < self.min_inliers:
                continue
            if n_inl >= self.min_inliers:
                return (Rq, tq, n_inl, int(i))
        return None

    # ------------------------------------------------------------------

    def optimize(self, propagate: bool = True) -> Optional[np.ndarray]:
        """Pose-graph optimization over the full keyframe history (SE(3) or
        Sim(3), per use_sim3).

        Caches de-scaled corrected SE(3) poses in self.corrected, node
        scales in self.corrected_scale, and per-entry world-side Sim(3)
        corrections in self.last_corrections. When `propagate`, every
        database entry adopts its corrected pose and its landmark snapshot
        moves with the entry's own correction (locally rigid/similar
        deformation — keeps the database fresh for future verifications).
        Returns corrected camera-to-world centers [N, 3] or None."""
        n = len(self.entries)
        if n < 3:
            return None
        # capacity grows in powers of two past the configured floor (each
        # growth recompiles once; the CG solver keeps big graphs tractable).
        # Round 1 silently returned None past max_nodes — loop closure just
        # stopped working on long runs with no signal.
        N = self.pg_cfg.max_nodes
        while N < n:
            N *= 2
        E = self.pg_cfg.max_edges
        while E < N * 4:
            E *= 2

        R0 = np.stack([e.R for e in self.entries])
        t0 = np.stack([e.t for e in self.entries])

        ii, jj, Rm, tm, sm, w = [], [], [], [], [], []
        for k in range(n - 1):
            # numpy, not jnp: one device dispatch per odometry edge would
            # cost n-1 dispatches per optimize() call
            Rr, tr = _np_se3_relative(R0[k], t0[k], R0[k + 1], t0[k + 1])
            ii.append(k)
            jj.append(k + 1)
            Rm.append(Rr)
            tm.append(tr)
            sm.append(1.0)
            w.append(1.0)
        for e in self.loop_edges:
            ii.append(e.i)
            jj.append(e.j)
            Rm.append(e.R)
            tm.append(e.t)
            sm.append(e.scale)
            # information weighting: the mutual-verification rotation
            # disagreement estimates the edge's uncertainty; a 7-degree
            # edge should not be allowed to twist the trajectory through
            # its full lever arm (measured 12-14 map-unit keyframe moves
            # from one such edge), while a tight sub-2-degree revisit
            # keeps full authority
            info = min(4.0, (2.0 / max(e.rot_sigma_deg, 0.5)) ** 2)
            w.append(self.pg_cfg.loop_weight * info)
        ne = len(ii)
        if ne > E:   # can't happen with E >= 4N; fail loudly if it ever does
            raise RuntimeError(
                f"pose graph edge overflow: {ne} edges > capacity {E}")

        def pad(a, target, shape_tail):
            out = np.zeros((target,) + shape_tail, np.float32)
            out[: len(a)] = np.asarray(a)
            return out

        eye_fill_N = (np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
                      * (np.arange(N) >= n)[:, None, None])
        eye_fill_E = (np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
                      * (np.arange(E) >= ne)[:, None, None])
        common = dict(
            node_valid=jnp.asarray(np.arange(N) < n),
            i=jnp.asarray(pad(ii, E, ()).astype(np.int32)),
            j=jnp.asarray(pad(jj, E, ()).astype(np.int32)),
            Rm=jnp.asarray(pad(Rm, E, (3, 3)) + eye_fill_E),
            tm=jnp.asarray(pad(tm, E, (3,))),
            weight=jnp.asarray(pad(w, E, ())),
            edge_valid=jnp.asarray(np.arange(E) < ne),
        )
        R_in = jnp.asarray(pad(R0, N, (3, 3)) + eye_fill_N)
        t_in = jnp.asarray(pad(t0, N, (3,)))

        if self.use_sim3:
            g = Sim3Graph(
                R=R_in, t=t_in, s=jnp.ones(N, jnp.float32),
                sm=jnp.asarray(np.where(np.arange(E) < ne,
                                        pad(sm, E, ()), 1.0)
                               .astype(np.float32)),
                **common)
            res = optimize_sim3_graph_jit(g, self.pg_cfg)
            scales = np.asarray(res.s[:n])
        else:
            g = PoseGraph(R=R_in, t=t_in, **common)
            res = optimize_pose_graph_jit(g, self.pg_cfg)
            scales = np.ones(n, np.float32)

        Rn = np.asarray(res.R[:n])
        tn = np.asarray(res.t[:n])
        # de-scaled SE(3): x_cam_metric = (1/s)(s R X + t) = R X + t/s
        self.corrected = [(Rn[k], tn[k] / scales[k]) for k in range(n)]
        self.corrected_scale = list(scales)

        # world-side correction per entry: G_k = S_new_k^-1 . S_old_k maps
        # pre-correction world points near keyframe k to corrected world
        # (S_old has unit scale; S_new = (Rn, tn, s)).
        self.last_corrections = []
        for k in range(n):
            Rg, tg, sg = _np_sim3_compose(
                *_np_sim3_inverse(Rn[k], tn[k], float(scales[k])),
                R0[k], t0[k], 1.0)
            self.last_corrections.append(
                (np.asarray(Rg), np.asarray(tg), float(sg)))

        if propagate:
            for k, e in enumerate(self.entries):
                Rg, tg, sg = self.last_corrections[k]
                if e.lm_world is not None:      # device entries propagate
                    e.lm_world = sg * (e.lm_world @ Rg.T) + tg  # on device
                Rk, tk = self.corrected[k]
                e.R = np.array(Rk, np.float32, copy=True)
                e.t = np.array(tk, np.float32, copy=True)

        centers = np.stack([-Rn[k].T @ tn[k] / scales[k] for k in range(n)])
        return centers
