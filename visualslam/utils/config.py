"""Frozen configuration tree for the whole engine.

The reference hardcodes every parameter at call sites (SURVEY.md §5 "Config":
numOctaves=4, sigma=1.6 at Diff_of_Gauss.cpp:742-743; k=0.04 at
Harris_corners.cpp:36; r=10 at Diff_of_Gauss.cpp:332; etc.). Here they live in
one frozen, hashable dataclass tree so a config doubles as a jit
static-argument: every jitted entry point takes `cfg` as a static arg and the
compiled program specializes on it.

Defaults reproduce the reference's behavioral spec (SURVEY.md §2.2), with
documented deltas where the reference has outright bugs (SURVEY.md §2.2
"quirks"): dense extrema scan instead of the stride-3 grid, L2 descriptor
normalization by default instead of max-norm (set `descriptor_norm="max"` for
reference behavior), and trilinear histogram binning as an option.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


class _Base:
    """Shared helpers: serialization + functional update."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict):
        names = {f.name: f for f in dataclasses.fields(cls)}
        kw: dict[str, Any] = {}
        for k, v in d.items():
            if k not in names:
                raise KeyError(f"{cls.__name__}: unknown config key {k!r}")
            f = names[k]
            # under `from __future__ import annotations` f.type is a string;
            # resolve nested config classes from this module's globals
            sub = f.type if isinstance(f.type, type) else globals().get(
                str(f.type), None)
            if isinstance(v, dict) and sub is not None and dataclasses.is_dataclass(sub):
                v = sub.from_dict(v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[k] = v
        return cls(**kw)


@dataclass(frozen=True)
class PyramidConfig(_Base):
    """SIFT scale-space pyramid (ref: GaussPyramid.hpp/.cpp; SURVEY.md §2.2).

    sigma(o, l) = 2^o * base_sigma * k^l with k = 2^(1/scale_samples)
    (absolute blur from the octave base, ref GaussPyramid.cpp:156-162).
    """

    num_octaves: int = 4                # ref Diff_of_Gauss.cpp:742
    scale_samples: int = 3              # s; levels = s+3, ref GaussPyramid.hpp:65
    base_sigma: float = 1.6             # ref Diff_of_Gauss.cpp:743
    initial_upsample: bool = True       # 2x linear before octave 0, cpp:109-110
    assumed_blur: float = 0.0           # blur already present in the input image
    truncate: float = 4.0               # Gaussian kernel radius = ceil(truncate*sigma)
    dtype: str = "float32"
    # "all": gradient products for every level (reference behavior,
    # GaussPyramid.cpp:65-104); "interior": only levels 1..s (the only ones
    # the SIFT pipeline reads) — ~2x less gradient work.
    grad_levels: str = "interior"
    # "matmul" (default): banded-Toeplitz einsums at HIGHEST precision;
    # "conv": XLA separable conv; "incremental": chained small-kernel
    # convs. Same math (tests/test_pyramid.py holds them to scipy).
    blur_mode: str = "matmul"

    @property
    def levels_per_octave(self) -> int:
        return self.scale_samples + 3

    @property
    def k_factor(self) -> float:
        return 2.0 ** (1.0 / self.scale_samples)

    def sigma_at(self, octave: int, level: int) -> float:
        """Absolute sigma of (octave, level) in octave-base pixel units."""
        return self.base_sigma * (self.k_factor ** level)

    def abs_sigma(self, octave: int, level: int) -> float:
        """Sigma in base-image units: 2^o * base_sigma * k^l (ref cpp:156-162)."""
        return (2.0 ** octave) * self.base_sigma * (self.k_factor ** level)


@dataclass(frozen=True)
class HarrisConfig(_Base):
    """Harris corner detector (ref: Harris_corners.cpp; SURVEY.md §2.2)."""

    k: float = 0.04                     # ref :36
    window: int = 3                     # structure-tensor window, ref :34
    nms_window: int = 5                 # ref :179
    blur_ksize: int = 3                 # pre-blur 3x3, ref :158
    blur_sigma: float = 0.8             # OpenCV's derived sigma for ksize=3
    response_threshold: float = 0.0     # keep response > 0, ref :60-62
    max_keypoints: int = 1024           # fixed-capacity output (masked)


@dataclass(frozen=True)
class SiftConfig(_Base):
    """DoG detection + SIFT description (ref: Diff_of_Gauss.cpp; SURVEY.md §2.2)."""

    contrast_threshold: float = 0.03    # interpolated |D| > 0.03, ref :231-249
    edge_r: float = 10.0                # tr^2/det < (r+1)^2/r, ref :105-108
    max_keypoints_per_octave: int = 512 # fixed-capacity per octave
    max_keypoints: int = 1024           # total capacity after merge
    num_orientation_bins: int = 36      # ref :112-133
    orientation_window: int = 16        # 16x16, ref :344-354
    orientation_sigma_scale: float = 1.5  # sigma = 1.5 * sigma(o,l), ref :346
    orientation_peak_ratio: float = 0.8 # spawn per bin > 0.8*max, ref :357-369
    max_orientations: int = 2           # capacity of spawned orientations per kp
    descriptor_width: int = 4           # 4x4 subregions
    descriptor_bins: int = 8            # 8 bins -> 128-D
    descriptor_window: int = 16         # 16x16 sampling window
    descriptor_clamp: float = 0.2       # clamp, ref :669-673
    descriptor_norm: str = "l2"         # "l2" (spec) | "max" (reference quirk f)
    localization_offset_max: float = 0.5  # reject if |z-hat| component beyond this * steps
    localize_iters: int = 1             # quadratic-fit refinement iterations
    dense_extrema: bool = True          # dense 26-neighbor scan (ref quirk c uses stride 3)
    patch_impl: str = "auto"            # orientation + descriptor stages:
    #                                     "auto" (the fused Triton kernels
    #                                     of ops/pallas/descriptor.py on a
    #                                     GPU, XLA elsewhere) | "pallas"
    #                                     (the kernels; interpreted on the
    #                                     CPU) | "xla". ops/pallas.kernel_route
    hist_compute: str = "f32"           # "f32" (exact) | "bf16": XLA-form
    #                                     histogram triangle-kernel einsum
    #                                     input dtype (~1e-2 relative error,
    #                                     half the memory traffic;
    #                                     accumulation is f32). The kernels
    #                                     always histogram in f32
    octave_capacity_decay: bool = False  # halve candidate capacity per
    #                                     octave (octave o has 1/4^o the
    #                                     pixels; flat capacity wastes
    #                                     gather/histogram work on slots
    #                                     that can never fill)

    @property
    def hist_compute_dtype(self):
        import jax.numpy as _jnp

        return _jnp.bfloat16 if self.hist_compute == "bf16" else None

    def octave_capacity(self, octave: int) -> int:
        if not self.octave_capacity_decay:
            return self.max_keypoints_per_octave
        # floor of 128 slots, but never above the configured per-octave cap
        return min(self.max_keypoints_per_octave,
                   max(self.max_keypoints_per_octave >> octave, 128))


@dataclass(frozen=True)
class OrbConfig(_Base):
    """ORB: oriented FAST + rotated BRIEF (absent in reference — README.md:19;
    built from scratch, SURVEY.md §2.3)."""

    num_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 0.08       # on [0,1] intensity scale (~20/255)
    fast_arc: int = 9                   # FAST-9 contiguous arc
    max_keypoints: int = 1024
    patch_size: int = 31                # orientation / BRIEF sampling patch
    brief_pairs: int = 256              # 256-bit descriptor
    brief_seed: int = 0x9E3779B9        # deterministic sampling-pattern seed
    harris_ranking: bool = True


@dataclass(frozen=True)
class MatchConfig(_Base):
    """Descriptor matching (absent in reference — README.md:17; SURVEY.md §2.3)."""

    ratio: float = 0.8                  # Lowe ratio test
    mutual: bool = True                 # mutual-best cross check
    metric: str = "l2"                  # "l2" | "hamming"
    max_matches: int = 512              # fixed-capacity matches (masked)


@dataclass(frozen=True)
class RansacConfig(_Base):
    """Batched-hypothesis RANSAC for the essential matrix (SURVEY.md §2.3)."""

    num_hypotheses: int = 512           # all scored in parallel (vmapped)
    sample_size: int = 8                # 8-point algorithm
    inlier_threshold: float = 1.5e-3    # Sampson distance in normalized coords
    seed: int = 0
    solver: str = "8pt"                 # "8pt" | "5pt" (minimal Nister-style
    #                                     solver, geometry/fivepoint.py:
    #                                     ~4x fewer hypotheses at equal
    #                                     inlier rates)


@dataclass(frozen=True)
class BAConfig(_Base):
    """Sliding-window bundle adjustment (absent in reference; BASELINE.json
    configs[3]; SURVEY.md §2.3)."""

    max_cameras: int = 10
    max_landmarks: int = 8192
    max_observations: int = 16384
    iters: int = 10
    damping_init: float = 1e-3
    damping_up: float = 10.0
    damping_down: float = 0.1
    huber_delta: float = 5.0e-3         # robust loss on normalized-plane residuals
    solver: str = "schur_dense"         # "schur_dense" (direct, small
    #                                     windows) | "schur_cg" (CG on the
    #                                     materialized reduced system) |
    #                                     "schur_mf" (matrix-free CG — the
    #                                     [C,L,6,3] coupling and [C,6,C,6]
    #                                     reduced system never materialize;
    #                                     scales to full sequences)
    cg_iters: int = 32
    fix_first_camera: bool = True
    fix_gauge_scale: bool = True
    async_ba: bool = False              # dispatch window BA without blocking;
    #                                     results are written back at the next
    #                                     keyframe (stage overlap: BA of
    #                                     window t runs while frames t+1..
    #                                     track — the PP analogue)


@dataclass(frozen=True)
class PoseGraphConfig(_Base):
    max_nodes: int = 256        # padding floor; loop_closure grows past it
    max_edges: int = 1024
    iters: int = 20
    damping: float = 1e-4
    loop_weight: float = 0.5    # loop-edge weight relative to odometry
    #                             (1.0). Deliberately conservative: a loop
    #                             edge's rotation error acts through the
    #                             full trajectory lever arm (a 5 deg edge
    #                             error moved keyframes 14 map units on
    #                             the KITTI-scale world), while odometry
    #                             is locally accurate; repeated closures
    #                             still pull genuine drift out gradually
    # "dense": materialize + factor the 6N x 6N system (exact, <= a few
    # hundred nodes); "cg": matrix-free block-Jacobi CG, O(E) per matvec —
    # scales to full-sequence graphs; "auto": dense below cg_threshold
    solver: str = "auto"
    cg_iters: int = 96
    cg_threshold: int = 192     # auto: switch to cg at this node count


@dataclass(frozen=True)
class LoopConfig(_Base):
    """Loop-closure detection (slam/loop_closure.py)."""

    enabled: bool = True
    sub_keypoints: int = 256            # local descriptors kept per keyframe
    cosine_threshold: float = 0.85      # global-descriptor retrieval gate
    min_inliers: int = 25               # PnP inliers to accept a loop
    exclude_recent: int = 10            # temporal exclusion window (keyframes)
    cooldown_keyframes: int = 8         # after an accepted closure, suppress
    #                                     further closures for this many
    #                                     keyframes: corridor-overlap revisits
    #                                     otherwise re-fire every batch with
    #                                     noisy Sim(3) scale estimates
    #                                     (measured swings 0.83-1.14 on the
    #                                     KITTI-scale loop world) and the
    #                                     repeated map warps kill tracking
    db_capacity: int = 512              # device-resident database entries
    #                                     (slam/engine.py ring; static per
    #                                     compiled batch program)
    sim3: bool = True                   # 7-DoF Sim(3) graph (monocular scale
    #                                     drift); False = rigid SE(3) graph
    consistency_rot_deg: float = 12.0   # mutual-PnP verification gates
    consistency_trans: float = 0.1      # (engine path): the forward and
    #                                     reciprocal solves must agree in
    #                                     relative rotation (degrees) and
    #                                     translation (as a fraction of the
    #                                     median matched-landmark depth —
    #                                     i.e. the parallax the error would
    #                                     induce). Single-sided PnP on far
    #                                     landmarks accepts depth-ambiguous
    #                                     wrong minima with healthy inlier
    #                                     counts
    max_baseline_frac: float = 0.15     # accept a loop edge only when the
    #                                     measured baseline is small vs the
    #                                     median matched-landmark depth: a
    #                                     genuine revisit has near-identical
    #                                     viewpoints (excellent shared-
    #                                     landmark PnP), while corridor
    #                                     overlap at baseline ~0.3-0.6x
    #                                     depth yields edges whose error
    #                                     exceeds the odometry drift they
    #                                     would "correct"
    max_scale: float = 1.5              # per-edge scale-ratio sanity gate:
    #                                     estimates outside [1/x, x] fall
    #                                     back to SE(3) (a wrong-scale warp
    #                                     of the live map kills tracking;
    #                                     a missing one only costs drift).
    #                                     Kept permissive — genuine long-
    #                                     loop monocular drift can exceed
    #                                     30%; the mutual-PnP consistency
    #                                     gates are the primary defense
    #                                     against garbage edges


@dataclass(frozen=True)
class SlamConfig(_Base):
    """Top-level engine config: composes every subsystem."""

    pyramid: PyramidConfig = field(default_factory=PyramidConfig)
    harris: HarrisConfig = field(default_factory=HarrisConfig)
    sift: SiftConfig = field(default_factory=SiftConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    pose_graph: PoseGraphConfig = field(default_factory=PoseGraphConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    frontend: str = "sift"              # "sift" | "orb" | "harris"
    keyframe_min_inliers: int = 40
    keyframe_max_gap: int = 5
    keyframe_min_gap: int = 1           # frames that must pass before the
    #                                     next keyframe (prevents keyframe-
    #                                     every-frame churn that evicts the
    #                                     window before landmarks mature)
    local_map_size: int = 1024          # covisible landmarks tracked per frame
    map_landmarks: int = 16384          # host landmark-pool capacity —
    #                                     decoupled from ba.max_landmarks
    #                                     (the BA padded shapes) so feature-
    #                                     rich scenes can't force the pool
    #                                     to recycle still-observed slots
    track_gate: float = 0.05            # local-map match gate: max distance
    #                                     between predicted projection and
    #                                     keypoint (normalized-plane units)
    image_height: int = 376             # KITTI-odometry grayscale default
    image_width: int = 1241

    @classmethod
    def from_json(cls, s: str) -> "SlamConfig":
        return cls.from_dict(json.loads(s))


DEFAULT_CONFIG = SlamConfig()

# Production / throughput profile: no initial 2x upsample (4x less pyramid +
# detection work; the upsample exists for small-image SIFT parity — KITTI
# frames have plenty of resolution without it), BA problem sized for the
# sliding window's actual content instead of worst-case capacity (smaller
# device program, same math), BA overlapped with tracking (async_ba), and a
# keyframe threshold matched to the ~50-inlier steady state of wide frames.
# Reference-parity behavior stays on DEFAULT_CONFIG.
FAST_CONFIG = SlamConfig(
    pyramid=PyramidConfig(initial_upsample=False, num_octaves=3),
    # window capacities sized to measured content (engine local map holds
    # <= 2048 slots; a 10-kf window carries ~1.5-4k observations): the BA's
    # per-LM-iteration device time scales with the PADDED shapes, and the
    # flush of this solve is serial with the next batch. Global BA is
    # unaffected — it
    # re-sizes capacities from the actual problem (slam/global_ba.py:151).
    ba=BAConfig(max_landmarks=2048, max_observations=6144, async_ba=True),
    # KITTI-width frames carry ~2k useful features (ORB-SLAM uses 2000 at
    # 1241x376); capacity scales with image area or tracking starves
    sift=SiftConfig(max_keypoints=2048, max_keypoints_per_octave=1024,
                    hist_compute="bf16", octave_capacity_decay=True),
    orb=OrbConfig(max_keypoints=2048),
    match=MatchConfig(max_matches=1024),
    local_map_size=2048,
    keyframe_min_inliers=25,
    keyframe_min_gap=2,
    # local-map tracking holds 35+ inliers over an 8-frame gap; the
    # inlier floor (keyframe_min_inliers) still forces an early keyframe
    # when tracking degrades. Accuracy cost vs DEFAULT_CONFIG depends on
    # frame size: near parity at KITTI width (what this profile is tuned
    # for); at the 240x376 synthetic world the dolly-60 ATE is ~0.42 m
    # fast vs ~0.09 m reference — see ACCURACY.md (regenerate with
    # `cli accuracy`) for the current measured rows.
    keyframe_max_gap=8,
)
