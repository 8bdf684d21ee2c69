"""SIFT frontend: DoG detection -> localization -> orientation -> descriptors.

A batched-array rebuild of the reference's flagship `DoG` pipeline
(Diff_of_Gauss.cpp:727-876, call stack in SURVEY.md §3.2):

  reference (per-keypoint C++ loops)          here (batched array programs)
  ------------------------------------------  --------------------------------
  initialKeypointDetection (:254-297)         ops.extrema.detect_extrema
  FeaturePointLocalization (:223-251)         ops.extrema.localize (batched fit)
  computeEdgeResponse      (:79-109)          inside localize (edge test)
  filterKeypoints + orientationHistogram      orientation_pass (soft
    (:301-372, :112-133)                        histograms + parabolic peaks)
  Rotation window + SIFT   (:528-693)         describe_octave (rotated-grid
                                                bilinear sampling + soft binning)

Documented deltas from reference quirks (SURVEY.md §2.2): dense extrema scan
(not stride-3), fitted sub-pixel offsets applied (clamped to +-0.5), paper
Gaussian weighting instead of blurring the magnitude ROI, parabolic peak
interpolation, L2 descriptor norm by default (descriptor_norm="max" restores
the reference's max-norm).

All keypoint sets are fixed-capacity masked SoA; octaves are a static Python
loop producing per-octave Features merged by response into the final set.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from visualslam.models.pyramid import ScaleSpace, build_pyramid
from visualslam.models.types import Features, Keypoints
from visualslam.ops.extrema import detect_extrema
from visualslam.ops.histograms import (
    gaussian_window,
    histogram_peaks,
    soft_histogram,
)
from visualslam.ops.pallas import kernel_route
from visualslam.ops.patches import (
    crop_patches,
    rotated_grid,
    tent_sample_patches,
)
from visualslam.utils.config import PyramidConfig, SiftConfig
from visualslam.utils.masked import top_k_select


class _OctaveKps(NamedTuple):
    yx_oct: jnp.ndarray     # [K, 2] refined (y, x) in octave coords
    level: jnp.ndarray      # [K] int32 DoG/gauss level index
    scale_off: jnp.ndarray  # [K] fitted sub-pixel scale offset ds
    orientation: jnp.ndarray  # [K] degrees
    response: jnp.ndarray   # [K] |contrast|
    valid: jnp.ndarray      # [K] bool


def _orientation_pass(src, route, lvl, y, x, offset, response, valid,
                      pyr_cfg: PyramidConfig, cfg: SiftConfig):
    """Assign up to cfg.max_orientations orientations per candidate, then
    re-select the per-octave top-K among the spawned keypoints.

    src is what the orientation and descriptor stages sample from: with a
    kernel route, (mag stack, ori stack, level per candidate), gathered
    from directly; otherwise ONE pre-cropped (mag, ori) patch per
    candidate with its origin (crop_patches' (patches, y0, x0)), whose
    16x16 integer window this stage reads by exact tent selection.
    Returns (_OctaveKps, spawn candidate indices [K] for re-indexing the
    per-candidate parts of src)."""
    k = lvl.shape[0]        # keep the octave's (possibly decayed) capacity
    win = cfg.orientation_window
    yx_int = jnp.stack([y, x], -1).astype(jnp.float32)

    # sigma of the (refined) level in octave-pixel units
    lvl_f = lvl.astype(jnp.float32) + offset[:, 0]
    sigma_oct = pyr_cfg.base_sigma * pyr_cfg.k_factor ** lvl_f

    if route:
        from visualslam.ops.pallas.descriptor import orient_hist

        mag, ori, glvl = src
        hist = orient_hist(mag, ori, glvl, yx_int,
                           cfg.orientation_sigma_scale * sigma_oct,
                           cfg.num_orientation_bins,
                           interpret=route == "interpret")           # [K, 36]
    else:
        # integer 16x16 grid about the candidate (same offsets as an
        # extract_patches window): tent weights reduce to exact one-hot
        # rows, so this is a lossless window view of the shared patch
        patches, py0, px0 = src
        offs = jnp.arange(win, dtype=jnp.float32) - win // 2
        gy, gx = jnp.meshgrid(offs, offs, indexing="ij")
        grid = jnp.stack([gy, gx], axis=-1)[None]            # [1,S,S,2]
        both = tent_sample_patches(
            patches, py0, px0, yx_int[:, None, None, :] + grid)  # [K,S,S,2]
        mag = both[..., 0]
        ori = both[..., 1]
        w = gaussian_window(win,
                            cfg.orientation_sigma_scale * sigma_oct)
        hist = soft_histogram(ori.reshape(-1, win * win),
                              (mag * w).reshape(-1, win * win),
                              cfg.num_orientation_bins, 360.0,
                              interpolate=True,
                              compute_dtype=cfg.hist_compute_dtype)
    angles, _, peak_valid = histogram_peaks(
        hist, cfg.max_orientations, cfg.orientation_peak_ratio, 360.0)

    # Spawn: flatten [K, P] -> [K*P]
    P = cfg.max_orientations
    yx_ref = yx_int + offset[:, 1:3]
    yx_sp = jnp.repeat(yx_ref, P, axis=0)
    lvl_sp = jnp.repeat(lvl, P, axis=0)
    ds_sp = jnp.repeat(offset[:, 0], P, axis=0)
    resp_sp = jnp.repeat(response, P, axis=0)
    valid_sp = jnp.repeat(valid, P, axis=0) & peak_valid.reshape(-1)
    ang_sp = angles.reshape(-1)

    # Keep the octave capacity fixed: top-K by response among spawned kps.
    # Tiny deterministic tiebreak so two orientations of one keypoint don't
    # get dropped nondeterministically.
    tiebreak = jnp.arange(resp_sp.shape[0], dtype=jnp.float32) * 1e-12
    idx, mask = top_k_select(resp_sp - tiebreak, valid_sp, k)
    kps = _OctaveKps(
        yx_oct=yx_sp[idx] * mask[:, None],
        level=jnp.where(mask, lvl_sp[idx], 1),
        scale_off=jnp.where(mask, ds_sp[idx], 0.0),
        orientation=jnp.where(mask, ang_sp[idx], 0.0),
        response=jnp.where(mask, resp_sp[idx], 0.0),
        valid=mask,
    )
    return kps, idx // P       # spawned row -> originating candidate


def describe_octave(src, route, cand_idx, kps: _OctaveKps,
                    cfg: SiftConfig) -> jnp.ndarray:
    """128-D descriptors for one octave's keypoints: rotation-normalized
    16x16 window -> 4x4 subregions x 8 orientation bins (ref SIFT
    :561-693). Samples the SAME src as the orientation pass, re-indexed to
    the spawned keypoints via cand_idx. The XLA form interpolates the
    rotated grid inside the cropped patch with tent-weight matmuls
    (patch=28 covers the rotated radius win/2*sqrt(2)+0.5)."""
    win = cfg.descriptor_window
    width = cfg.descriptor_width
    nbins = cfg.descriptor_bins
    D = width * width * nbins
    K = kps.valid.shape[0]

    if route:
        from visualslam.ops.pallas.descriptor import descriptor

        mag, ori, glvl = src
        desc = descriptor(mag, ori, glvl[cand_idx], kps.yx_oct,
                          kps.orientation, width, nbins,
                          interpret=route == "interpret")
    else:
        patches, py0, px0 = (a[cand_idx] for a in src)
        coords = rotated_grid(kps.yx_oct, kps.orientation, win, step=1.0)
        both = tent_sample_patches(patches, py0, px0, coords)    # [K,S,S,2]
        mag = both[..., 0]
        ori = both[..., 1]
        ori_rel = jnp.mod(ori - kps.orientation[:, None, None], 360.0)

        # Static spatial structure: Gaussian weight (sigma = half window,
        # SIFT paper; the reference instead blurs the magnitude ROI —
        # documented delta). The region assignment is a static reshape:
        # the 16x16 grid splits into width x width cells of cell x cell
        # samples, so the histogram is built per-region with an 8-wide
        # one-hot (16x less memory traffic than a 128-wide one-hot).
        cell = win // width
        w_spatial = gaussian_window(win, win / 2.0)              # [S, S]

        def to_regions(a):   # [K, S, S] -> [K, regions, cell*cell]
            a = a.reshape(K, width, cell, width, cell)
            return a.transpose(0, 1, 3, 2, 4).reshape(
                K, width * width, cell * cell)

        wmag = to_regions(mag * w_spatial[None])
        hist = soft_histogram(to_regions(ori_rel), wmag, nbins, 360.0,
                              interpolate=True,
                              compute_dtype=cfg.hist_compute_dtype)
        desc = hist.reshape(K, D)

    if cfg.descriptor_norm == "max":
        # reference behavior (quirk f): normalize by max, clamp, renormalize
        m = jnp.max(desc, axis=-1, keepdims=True)
        desc = desc / jnp.maximum(m, 1e-12)
        desc = jnp.minimum(desc, cfg.descriptor_clamp)
        m = jnp.max(desc, axis=-1, keepdims=True)
        desc = desc / jnp.maximum(m, 1e-12)
    else:
        n = jnp.linalg.norm(desc, axis=-1, keepdims=True)
        desc = desc / jnp.maximum(n, 1e-12)
        desc = jnp.minimum(desc, cfg.descriptor_clamp)
        n = jnp.linalg.norm(desc, axis=-1, keepdims=True)
        desc = desc / jnp.maximum(n, 1e-12)
    return desc * kps.valid[:, None]


def detect_and_describe_sift(img: jnp.ndarray, pyr_cfg: PyramidConfig,
                             cfg: SiftConfig) -> Features:
    """Full SIFT frontend on one [H, W] image -> fixed-capacity Features.

    Jit with both configs static."""
    route = kernel_route(cfg.patch_impl)
    if route and (cfg.orientation_window, cfg.descriptor_window) != (16, 16):
        raise ValueError("the patch kernels sample 16x16 windows; use "
                         "patch_impl='xla' for other window sizes")
    ss = build_pyramid(img, pyr_cfg)
    base_scale = 0.5 if pyr_cfg.initial_upsample else 1.0

    per_oct = []
    for o in range(pyr_cfg.num_octaves):
        lvl, y, x, offset, resp, valid = detect_extrema(
            ss.dog[o], cfg, capacity=cfg.octave_capacity(o))
        glvl = lvl - ss.grad_level_offset
        if route:
            src = (ss.grad_mag[o], ss.grad_ori[o], glvl)
        else:
            # ONE (mag, ori) patch crop per candidate, shared by the
            # orientation and descriptor stages
            mag_ori = jnp.stack([ss.grad_mag[o], ss.grad_ori[o]], axis=-1)
            yx_int = jnp.stack([y, x], -1).astype(jnp.float32)
            src = crop_patches(mag_ori, glvl, yx_int, 28)
        kps, cand_idx = _orientation_pass(src, route, lvl, y, x, offset,
                                          resp, valid, pyr_cfg, cfg)
        desc = describe_octave(src, route, cand_idx, kps, cfg)
        factor = (2.0 ** o) * base_scale
        lvl_f = kps.level.astype(jnp.float32) + kps.scale_off
        sigma_base = factor * pyr_cfg.base_sigma * pyr_cfg.k_factor ** lvl_f
        per_oct.append((kps, desc, factor, sigma_base))

    # Merge octaves: global top max_keypoints by response.
    K = cfg.max_keypoints
    resp_all = jnp.concatenate([k.response for k, _, _, _ in per_oct])
    valid_all = jnp.concatenate([k.valid for k, _, _, _ in per_oct])
    idx, mask = top_k_select(resp_all, valid_all, K)

    def cat(field_fn):
        return jnp.concatenate([field_fn(t) for t in per_oct], axis=0)

    yx_base = cat(lambda t: t[0].yx_oct * t[2])
    yx_oct = cat(lambda t: t[0].yx_oct)
    octave = jnp.concatenate([
        jnp.full_like(t[0].level, o)
        for o, t in enumerate(per_oct)])
    level = cat(lambda t: t[0].level)
    sigma = cat(lambda t: t[3])
    orientation = cat(lambda t: t[0].orientation)
    desc_all = cat(lambda t: t[1])

    kps = Keypoints(
        yx=yx_base[idx] * mask[:, None],
        yx_oct=yx_oct[idx] * mask[:, None],
        octave=jnp.where(mask, octave[idx], 0),
        level=jnp.where(mask, level[idx], 0),
        sigma=jnp.where(mask, sigma[idx], 0.0),
        orientation=jnp.where(mask, orientation[idx], 0.0),
        response=jnp.where(mask, resp_all[idx], 0.0),
        valid=mask,
    )
    return Features(kps, desc_all[idx] * mask[:, None])


detect_and_describe_sift_jit = jax.jit(detect_and_describe_sift,
                                       static_argnums=(1, 2))
