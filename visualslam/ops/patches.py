"""Per-keypoint window extraction and rotated sampling.

Replaces the reference's gather-heavy window flows: plain 16x16 ROI crops
(Diff_of_Gauss.cpp:329-348) and integer rotated-window point-list sampling
(rotation.cpp:112-130 `getRotatedWindowPoints`, Diff_of_Gauss.cpp:528-559
`rotateImageSection`). Axis-aligned windows are vmapped
dynamic_slices (clamped, replicating the reference's padded-octave reads);
rotated windows are an affine resampling — each keypoint's window grid is
rotated about its center and sampled bilinearly with one batched gather,
instead of the reference's per-pixel nearest-neighbor integer rotation
(which it admits is axis-swapped, SURVEY.md §2.2 quirk b).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def extract_patches(img: jnp.ndarray, yx: jnp.ndarray, size: int,
                    level_idx: jnp.ndarray | None = None) -> jnp.ndarray:
    """Crop [K, size, size] windows centered at yx (rounded to int).

    img: [H, W] or [L, H, W] (with level_idx [K] selecting the leading
    axis), optionally with a trailing channel axis C ([H, W, C] /
    [L, H, W, C]) — channels are cropped in the SAME gather, which halves
    the gather cost vs one extract per channel.
    Windows are clamped inside the image — equivalent to the reference's
    replicate-padded octave reads only near borders (clamp shifts the window
    instead of replicating; detection margins keep keypoints off borders).
    """
    channels = img.ndim - (2 if level_idx is None else 3)
    H, W = img.shape[-2 - channels: img.ndim - channels]
    r = size // 2
    y0 = jnp.clip(jnp.round(yx[:, 0]).astype(jnp.int32) - r, 0, H - size)
    x0 = jnp.clip(jnp.round(yx[:, 1]).astype(jnp.int32) - r, 0, W - size)

    # One flat element gather (a vmapped dynamic_slice lowers to a gather
    # of K strided sub-arrays). Flat row index =
    # ((lvl*H) + y0+dy)*W + x0+dx; a trailing channel axis rides along by
    # gathering rows of the [L*H*W, C] view.
    if level_idx is None:
        base = y0 * W + x0
    else:
        base = (level_idx * H + y0) * W + x0                    # [K]
    dy = jnp.arange(size, dtype=jnp.int32)[:, None] * W
    dx = jnp.arange(size, dtype=jnp.int32)[None, :]
    idx = base[:, None, None] + (dy + dx)[None]                 # [K, S, S]
    if channels:
        flat = img.reshape(-1, img.shape[-1])
        return jnp.take(flat, idx, axis=0)                      # [K, S, S, C]
    return jnp.take(img.reshape(-1), idx, axis=0)               # [K, S, S]


def sample_bilinear(img: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample img[H, W] at float coords [..., 2] (y, x), edge-clamped."""
    H, W = img.shape
    y = jnp.clip(coords[..., 0], 0.0, H - 1.0)
    x = jnp.clip(coords[..., 1], 0.0, W - 1.0)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, H - 1)
    x1 = jnp.minimum(x0 + 1, W - 1)
    wy = y - y0.astype(y.dtype)
    wx = x - x0.astype(x.dtype)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
            + wy * (1 - wx) * v10 + wy * wx * v11)


def sample_bilinear_stack(stack: jnp.ndarray, level_idx: jnp.ndarray,
                          coords: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample stack[L, H, W] or [L, H, W, C] at per-item levels.

    level_idx: [K] int32; coords: [K, ..., 2] float (y, x) within the level
    image. One fused gather: the stack is viewed as a single [L*H, W(, C)]
    image and y-coords are offset by level*H after clamping inside the
    level, so interpolation never crosses level boundaries. A trailing
    channel axis C is gathered in the same indexing (amortizes gather cost
    across channels). Returns [K, ...] or [K, ..., C].
    """
    L, H, W = stack.shape[:3]
    channels = stack.ndim == 4
    flat = stack.reshape((L * H, W) + stack.shape[3:])
    y = jnp.clip(coords[..., 0], 0.0, H - 1.0)
    x = jnp.clip(coords[..., 1], 0.0, W - 1.0)
    y0 = jnp.floor(y).astype(jnp.int32)
    x0 = jnp.floor(x).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, H - 1)
    x1 = jnp.minimum(x0 + 1, W - 1)
    wy = y - y0.astype(y.dtype)
    wx = x - x0.astype(x.dtype)
    off = level_idx * H
    off = off.reshape(off.shape + (1,) * (coords.ndim - 2))
    v00 = flat[y0 + off, x0]
    v01 = flat[y0 + off, x1]
    v10 = flat[y1 + off, x0]
    v11 = flat[y1 + off, x1]
    if channels:
        wy = wy[..., None]
        wx = wx[..., None]
    return ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
            + wy * (1 - wx) * v10 + wy * wx * v11)


_SEG = 64       # row-segment width of the crop gather (see crop_patches)


def crop_patches(stack: jnp.ndarray, level_idx: jnp.ndarray,
                 center_yx: jnp.ndarray, patch: int):
    """Crop one patch per keypoint from a level stack. Returns
    (patches [K, C, Ph, Pw], y0 [K], x0 [K]) — CHANNEL-FIRST — with the
    window origins, so callers can sample inside the patch
    (tent_sample_patches).

    Each gather row is an aligned 64-pixel segment (256 B contiguous)
    and a window takes 2 consecutive segments per row, so the gather moves
    whole rows instead of single elements; the output is channel-first
    [K, C, Ph, 128] (a trailing channel dim of 2 is a poor minor axis).

    The window is guaranteed inside [x0, x0+128) for any patch <= 65; the
    x-overhang beyond W reads edge-replicated padding. Levels narrower
    than two segments fall back to full-width rows."""
    L, H, W = stack.shape[:3]
    if stack.ndim == 4:                     # channels-last input
        C = stack.shape[-1]
        stack = jnp.moveaxis(stack, -1, 0).reshape(C * L, H, W)
    else:
        C = 1
    K = center_yx.shape[0]
    ph = min(patch, H)
    y0 = jnp.clip(jnp.round(center_yx[:, 0]).astype(jnp.int32) - ph // 2,
                  0, H - ph)
    dy = jnp.arange(ph, dtype=jnp.int32)
    # per-channel level rows: channel c of level l lives at row c*L + l
    lvl_c = (jnp.arange(C, dtype=jnp.int32)[None, :] * L
             + level_idx[:, None])                              # [K, C]

    if W < 2 * _SEG:
        # tiny level: gather full-width rows
        flat = stack.reshape(C * L * H, W)
        idx = ((lvl_c[:, :, None] * H + y0[:, None, None])
               + dy[None, None, :])                             # [K, C, Ph]
        patches = jnp.take(flat, idx, axis=0)                   # [K,C,Ph,W]
        return patches, y0, jnp.zeros_like(y0)

    assert patch <= _SEG + 1, (
        f"patch {patch} can escape the two-segment window (max {_SEG + 1})")
    nseg = -(-W // _SEG)
    Wp = nseg * _SEG
    if Wp != W:
        stack = jnp.pad(stack, ((0, 0), (0, 0), (0, Wp - W)), mode="edge")
    x0d = jnp.clip(jnp.round(center_yx[:, 1]).astype(jnp.int32)
                   - patch // 2, 0, W - min(patch, W))
    seg = jnp.minimum(x0d // _SEG, nseg - 2)
    x0 = seg * _SEG
    flat = stack.reshape(C * L * H * nseg, _SEG)
    base = (lvl_c * H + y0[:, None]) * nseg + seg[:, None]      # [K, C]
    idx = (base[:, :, None, None] + dy[None, None, :, None] * nseg
           + jnp.arange(2, dtype=jnp.int32))                    # [K,C,Ph,2]
    rows = jnp.take(flat, idx, axis=0)                          # [K,C,Ph,2,S]
    patches = rows.reshape(K, C, ph, 2 * _SEG)
    return patches, y0, x0


def tent_sample_patches(patches: jnp.ndarray, y0: jnp.ndarray,
                        x0: jnp.ndarray, coords: jnp.ndarray) -> jnp.ndarray:
    """Bilinear-sample INSIDE pre-cropped patches with two tent-weight
    matmuls (each tent row holds exactly the two bilinear
    weights of a sample; integer coords reduce to exact one-hot selection).
    patches: [K, C, Ph, Pw] channel-first (crop_patches layout) with
    origins (y0, x0); coords: [K, ..., 2] absolute (y, x). Samples outside
    the patch edge-clamp."""
    K, C, ph, pw = patches.shape
    shape = coords.shape[1:-1]
    py = jnp.clip(coords[..., 0].reshape(K, -1)
                  - y0[:, None].astype(coords.dtype), 0.0, ph - 1.0)
    px = jnp.clip(coords[..., 1].reshape(K, -1)
                  - x0[:, None].astype(coords.dtype), 0.0, pw - 1.0)
    taps_y = jnp.arange(ph, dtype=coords.dtype)
    taps_x = jnp.arange(pw, dtype=coords.dtype)
    wy = jnp.maximum(0.0, 1.0 - jnp.abs(py[..., None] - taps_y))  # [K, N, Ph]
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(px[..., None] - taps_x))
    # HIGHEST precision: bf16/TF32 passes would quantize the interpolation
    # weights (~1e-2 / 1e-3 error); exact bilinear needs full f32
    t = jnp.einsum("kni,kcij->kcnj", wy, patches,
                   precision=jax.lax.Precision.HIGHEST)
    out = jnp.einsum("kcnj,knj->knc", t, wx,
                     precision=jax.lax.Precision.HIGHEST)
    return out.reshape((K,) + shape + (C,))


def sample_bilinear_patches(stack: jnp.ndarray, level_idx: jnp.ndarray,
                            center_yx: jnp.ndarray, coords: jnp.ndarray,
                            patch: int) -> jnp.ndarray:
    """Bilinear sample like sample_bilinear_stack, but crop one
    contiguous [patch, patch] window per keypoint, then interpolate INSIDE
    the patch with two tent-weight matmuls (crop_patches +
    tent_sample_patches).

    coords: [K, ..., 2] absolute (y, x) sample positions — every sample
    must fall within patch/2 - 1 px of its center (true for rotated
    descriptor grids: radius win/2*sqrt(2) + 0.5 < patch/2 - 1)."""
    channels = stack.ndim == 4
    patches, y0, x0 = crop_patches(stack, level_idx, center_yx, patch)
    out = tent_sample_patches(patches, y0, x0, coords)
    return out if channels else out[..., 0]


def crop_windows(stack: jnp.ndarray, level_idx: jnp.ndarray,
                 center_yx: jnp.ndarray, size: int) -> jnp.ndarray:
    """extract_patches semantics (integer [K, size, size(,C)] windows) via
    the segment-gather crop + exact tent selection — the fast path for
    windows whose size exceeds extract_patches' efficient range."""
    channels = stack.ndim == 4
    patches, y0, x0 = crop_patches(stack, level_idx, center_yx, size)
    offs = jnp.arange(size, dtype=jnp.float32) - size // 2
    gy, gx = jnp.meshgrid(offs, offs, indexing="ij")
    grid = jnp.stack([gy, gx], axis=-1)[None]
    ctr = jnp.round(center_yx).astype(jnp.float32)
    out = tent_sample_patches(patches, y0, x0, ctr[:, None, None, :] + grid)
    return out if channels else out[..., 0]


def rotated_grid(yx: jnp.ndarray, angle_deg: jnp.ndarray, size: int,
                 step: jnp.ndarray | float = 1.0) -> jnp.ndarray:
    """Sampling coords of a size x size window rotated by angle about yx.

    yx: [K, 2]; angle_deg: [K]; step: scalar or [K] spacing in pixels.
    Returns [K, size, size, 2] float coords. Rotating the GRID by +angle and
    sampling is what makes the descriptor rotation-invariant (the reference
    rotates the window CW by the keypoint angle, rotation.cpp:112-130).
    """
    theta = jnp.deg2rad(angle_deg)
    c, s = jnp.cos(theta), jnp.sin(theta)
    offs = jnp.arange(size, dtype=jnp.float32) - (size - 1) / 2.0
    gy, gx = jnp.meshgrid(offs, offs, indexing="ij")          # [S, S]
    step = jnp.asarray(step, jnp.float32)
    step = jnp.broadcast_to(step, theta.shape)
    # rotate (gy, gx) by theta: x' = c*gx - s*gy ; y' = s*gx + c*gy
    rx = c[:, None, None] * gx - s[:, None, None] * gy
    ry = s[:, None, None] * gx + c[:, None, None] * gy
    coords = jnp.stack([ry, rx], axis=-1) * step[:, None, None, None]
    return coords + yx[:, None, None, :]


def extract_rotated_patches(img: jnp.ndarray, yx: jnp.ndarray,
                            angle_deg: jnp.ndarray, size: int,
                            step: jnp.ndarray | float = 1.0) -> jnp.ndarray:
    """[K, size, size] rotation-normalized windows, bilinearly sampled."""
    coords = rotated_grid(yx, angle_deg, size, step)
    return sample_bilinear(img, coords)


def rotate_image(img: jnp.ndarray, angle_deg, center=None) -> jnp.ndarray:
    """Rotate a whole image CCW about a center (bilinear, same shape).

    The functional twin of SLAM::Rotation::rotate_mat_CCW / doubleCrop
    (rotation.cpp:66-84, 147-202) — one inverse-mapped bilinear resample
    instead of integer point lists; out-of-frame samples clamp to the edge.
    """
    H, W = img.shape
    if center is None:
        center = ((H - 1) / 2.0, (W - 1) / 2.0)
    yy = jnp.arange(H, dtype=jnp.float32)[:, None]
    xx = jnp.arange(W, dtype=jnp.float32)[None, :]
    coords = jnp.stack([jnp.broadcast_to(yy, (H, W)),
                        jnp.broadcast_to(xx, (H, W))], -1)
    # inverse mapping: sample source at the point that rotates TO (y, x)
    src = rotate_points(coords, angle_deg, center, clockwise=True)
    return sample_bilinear(img, src)


def rotate_points(yx: jnp.ndarray, angle_deg, center,
                  clockwise: bool = False) -> jnp.ndarray:
    """Rotate 2-D points about a center (float, exact — the functional twin
    of SLAM::Rotation's integer rotate_pt_CW/CCW overloads,
    rotation.cpp:19-62, without their nearest-integer truncation).

    yx: [..., 2] (y, x); angle in degrees; CCW by default in image coords
    (y down)."""
    theta = jnp.deg2rad(jnp.asarray(angle_deg, jnp.float32))
    if clockwise:
        theta = -theta
    c, s = jnp.cos(theta), jnp.sin(theta)
    center = jnp.asarray(center, jnp.float32)
    d = yx - center
    ry = s * d[..., 1] + c * d[..., 0]
    rx = c * d[..., 1] - s * d[..., 0]
    return jnp.stack([ry, rx], -1) + center
