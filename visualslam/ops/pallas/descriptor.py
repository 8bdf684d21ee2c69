"""Fused orientation-histogram and SIFT-descriptor kernels (Pallas, Triton).

The XLA form of these two stages (ops/patches.crop_patches +
tent_sample_patches + ops/histograms.soft_histogram) crops a [2, 28, 128]
(mag, ori) patch per keypoint and interpolates it with tent-weight
matmuls, which writes a [K, 2, 256, 128] float32 intermediate per stage
(268 MB per frame at an octave capacity of 1024). The stages are bound by
that memory traffic, not by arithmetic.

These kernels read the gradient level stack directly. A program takes a
block of keypoints; every sample of a keypoint's 16x16 window is a
bilinear gather (four loads per channel, exact float32 arithmetic, no
tensor-core rounding of the angle channel) from the keypoint's level, and
the circular soft histogram accumulates in registers. What reaches device
memory is the ~17x17 pixel footprint of each window in and one histogram
row out; no patch is cropped.

Sampling clamps to the level's edges, which is what the cropped patch of
the XLA form does too (crop windows are clamped inside the level and a
window's samples never leave its patch), so both forms sample the same
values. Angles interpolate linearly across the 0/360 wrap in both.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

S = 16                  # window side of both stages
_ORIENT_TK = 8          # keypoints per program: [8, 16, 64] tent block
_DESC_TK = 16           # keypoints per program: [16, 16, 8] accumulator
_NUM_WARPS = 4


def _tent(pos, nbins: int, nslots: int):
    """Circular soft-binning weights of positions pos [...] (in bin units)
    over nslots >= nbins output slots (slots past nbins get 0):
    ops/histograms.soft_histogram's triangle kernel, centers at b + 0.5."""
    b = jax.lax.broadcasted_iota(jnp.int32, pos.shape + (nslots,),
                                 pos.ndim).astype(jnp.float32)
    d = pos[..., None] - (b + 0.5)
    d = jnp.mod(d + nbins / 2.0, float(nbins)) - nbins / 2.0
    return jnp.where(b < nbins, jnp.maximum(0.0, 1.0 - jnp.abs(d)), 0.0)


def _bilinear(mag_ref, ori_ref, lvl, py, px):
    """Edge-clamped bilinear samples of both channels at float (py, px)."""
    _, H, W = mag_ref.shape
    py = jnp.clip(py, 0.0, H - 1.0)
    px = jnp.clip(px, 0.0, W - 1.0)
    fy = jnp.floor(py)
    fx = jnp.floor(px)
    wy = py - fy
    wx = px - fx
    y0 = fy.astype(jnp.int32)
    x0 = fx.astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, H - 1)
    x1 = jnp.minimum(x0 + 1, W - 1)

    def sample(ref):
        v00 = ref[lvl, y0, x0].astype(jnp.float32)
        v01 = ref[lvl, y0, x1].astype(jnp.float32)
        v10 = ref[lvl, y1, x0].astype(jnp.float32)
        v11 = ref[lvl, y1, x1].astype(jnp.float32)
        return ((1.0 - wy) * ((1.0 - wx) * v00 + wx * v01)
                + wy * ((1.0 - wx) * v10 + wx * v11))

    return sample(mag_ref), sample(ori_ref)


def _orient_kernel(cy_ref, cx_ref, lvl_ref, sig_ref, mag_ref, ori_ref,
                   out_ref, *, nbins: int):
    """Program: _ORIENT_TK keypoints x the 16 columns of their integer
    window, one window row per step."""
    _, H, W = mag_ref.shape
    tk = cy_ref.shape[0]
    cy = cy_ref[...].astype(jnp.int32)[:, None]
    cx = cx_ref[...].astype(jnp.int32)[:, None]
    lvl = jnp.broadcast_to(lvl_ref[...][:, None], (tk, S))
    sig = sig_ref[...][:, None]
    col = jax.lax.broadcasted_iota(jnp.int32, (1, S), 1)
    x = jnp.broadcast_to(jnp.clip(cx + col - S // 2, 0, W - 1), (tk, S))
    # gaussian_window centers on (S-1)/2 while the integer window offsets
    # run -S/2..S/2-1: the +0.5 matches the XLA form exactly
    gx = col.astype(jnp.float32) - (S - 1) / 2.0
    inv2s2 = 1.0 / (2.0 * sig * sig)
    nslots = out_ref.shape[1]
    acc = jnp.zeros((tk, nslots), jnp.float32)
    for row in range(S):
        y = jnp.broadcast_to(jnp.clip(cy + (row - S // 2), 0, H - 1), (tk, S))
        mag = mag_ref[lvl, y, x].astype(jnp.float32)
        ang = ori_ref[lvl, y, x].astype(jnp.float32)
        gy = row - (S - 1) / 2.0
        w = mag * jnp.exp(-(gy * gy + gx * gx) * inv2s2)           # [tk, S]
        tri = _tent(ang * (nbins / 360.0), nbins, nslots)          # [tk,S,n]
        acc += jnp.sum(tri * w[..., None], axis=1)
    out_ref[...] = acc


def _desc_kernel(cy_ref, cx_ref, lvl_ref, ang_ref, mag_ref, ori_ref,
                 out_ref, *, width: int):
    """Program: _DESC_TK keypoints x their width*width regions, one sample
    of every region's cell per step."""
    tk, regions, nbins = out_ref.shape
    cell = S // width
    cy = cy_ref[...][:, None]
    cx = cx_ref[...][:, None]
    lvl = jnp.broadcast_to(lvl_ref[...][:, None], (tk, regions))
    a = ang_ref[...][:, None]
    th = a * (math.pi / 180.0)
    c = jnp.cos(th)
    s = jnp.sin(th)
    r = jax.lax.broadcasted_iota(jnp.int32, (1, regions), 1)
    half = (S - 1) / 2.0
    acc = jnp.zeros((tk, regions, nbins), jnp.float32)
    for j in range(cell * cell):
        # window sample (row, col) of this step in every region; Gaussian
        # weight (sigma = S/2) over the unrotated grid
        gy = ((r // width) * cell + j // cell).astype(jnp.float32) - half
        gx = ((r % width) * cell + j % cell).astype(jnp.float32) - half
        w_sp = jnp.exp(-(gy * gy + gx * gx) / (2.0 * (S / 2.0) ** 2))
        py = cy + (s * gx + c * gy)                                # [tk, R]
        px = cx + (c * gx - s * gy)
        mag, ang = _bilinear(mag_ref, ori_ref, lvl, py, px)
        rel = jnp.mod(ang - a, 360.0)
        tri = _tent(rel * (nbins / 360.0), nbins, nbins)           # [tk,R,n]
        acc += tri * (mag * w_sp)[..., None]
    out_ref[...] = acc


def _pad(x, k_pad):
    return jnp.pad(x, (0, k_pad - x.shape[0]))


def _call(kernel, name, tk, out_tail, mag, ori, lvl, yx, extra, interpret):
    K = lvl.shape[0]
    k_pad = -(-K // tk) * tk
    params = (_pad(jnp.asarray(yx[:, 0], jnp.float32), k_pad),
              _pad(jnp.asarray(yx[:, 1], jnp.float32), k_pad),
              _pad(jnp.asarray(lvl, jnp.int32), k_pad),
              _pad(jnp.asarray(extra, jnp.float32), k_pad))
    key = pl.BlockSpec((tk,), lambda i: (i,))
    stack = pl.BlockSpec()          # the whole level stack, gathered from
    tail0 = (0,) * len(out_tail)
    out = pl.pallas_call(
        kernel,
        grid=(k_pad // tk,),
        in_specs=[key, key, key, key, stack, stack],
        out_specs=pl.BlockSpec((tk,) + out_tail, lambda i: (i,) + tail0),
        out_shape=jax.ShapeDtypeStruct((k_pad,) + out_tail, jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name=name,
    )(*params, mag, ori)
    return out[:K]


@functools.partial(jax.jit, static_argnames=("nbins", "interpret"))
def orient_hist(mag, ori, lvl, yx, sigma, nbins: int = 36, *,
                interpret: bool = False):
    """Orientation histograms of integer 16x16 windows.

    mag, ori: [L, H, W] gradient level stack (ori in degrees); lvl: [K]
    level of each keypoint; yx: [K, 2] integer window centers; sigma: [K]
    Gaussian weight sigma. Returns [K, nbins] float32 (soft circular
    binning, as ops/histograms.soft_histogram)."""
    nslots = pl.next_power_of_2(nbins)
    out = _call(functools.partial(_orient_kernel, nbins=nbins),
                "sift_orient_hist", _ORIENT_TK, (nslots,), mag, ori, lvl,
                yx, sigma, interpret)
    return out[:, :nbins]


@functools.partial(jax.jit, static_argnames=("width", "nbins", "interpret"))
def descriptor(mag, ori, lvl, yx, angle, width: int = 4, nbins: int = 8, *,
               interpret: bool = False):
    """Unnormalized SIFT descriptors over rotated 16x16 windows.

    mag, ori: [L, H, W] gradient level stack; lvl: [K] level; yx: [K, 2]
    float centers; angle: [K] degrees. Returns [K, width*width*nbins]
    float32, region-major (models/sift.describe_octave's layout)."""
    if S % width or nbins & (nbins - 1):
        raise ValueError(f"width must divide {S} and nbins must be a power "
                         f"of two; got width={width}, nbins={nbins}")
    out = _call(functools.partial(_desc_kernel, width=width),
                "sift_descriptor", _DESC_TK, (width * width, nbins), mag,
                ori, lvl, yx, angle, interpret)
    return out.reshape(out.shape[0], -1)
