"""Photographic synthetic sequences: exact plane-induced warps of a real
image (the reference's own photographs are the only real data bundled with
it — /root/reference/KeyPointDetection/images/). Used for sequence-scale
validation on real TEXTURE with exact ground truth: each frame is rendered
directly from the base image via piecewise-planar homographies
H = K (R + t n^T / d) K^-1, so geometric error cannot accumulate in the
data itself (tests/test_real_texture.py uses the same construction for
two-view pairs).

Pure numpy (no cv2 dependency): warping is inverse-mapped bilinear
sampling.
"""

from __future__ import annotations

import numpy as np


def _bilinear(img: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    h, w = img.shape
    ys = np.clip(ys, 0.0, h - 1.0)
    xs = np.clip(xs, 0.0, w - 1.0)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = ys - y0
    wx = xs - x0
    return ((1 - wy) * (1 - wx) * img[y0, x0]
            + (1 - wy) * wx * img[y0, x1]
            + wy * (1 - wx) * img[y1, x0]
            + wy * wx * img[y1, x1])


def warp_perspective(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Forward-warp img by homography H (destination <- inverse mapping),
    zero outside the source frame. Matches cv2.warpPerspective semantics
    up to the border policy."""
    h, w = img.shape
    Hinv = np.linalg.inv(H)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ones = np.ones_like(xx)
    src = Hinv @ np.stack([xx.ravel(), yy.ravel(), ones.ravel()])
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    out = _bilinear(img, sy.reshape(h, w), sx.reshape(h, w))
    return np.where(inside.reshape(h, w), out, 0.0).astype(img.dtype)


def warp_piecewise_planar(img: np.ndarray, K: np.ndarray, R: np.ndarray,
                          t: np.ndarray, depths: np.ndarray) -> np.ndarray:
    """Render the view of camera (R, t) (x_cam = R X + t) assuming the
    image tiles lie on fronto-parallel planes at `depths` [ny, nx]."""
    h, w = img.shape
    n_ty, n_tx = depths.shape
    out = np.zeros_like(img)
    Kinv = np.linalg.inv(K)
    ty = np.linspace(0, h, n_ty + 1).astype(int)
    tx = np.linspace(0, w, n_tx + 1).astype(int)
    n = np.array([0.0, 0.0, 1.0])
    for i in range(n_ty):
        for j in range(n_tx):
            H = K @ (R + np.outer(t, n) / depths[i, j]) @ Kinv
            mask = np.zeros_like(img)
            mask[ty[i]:ty[i + 1], tx[j]:tx[j + 1]] = 1.0
            wimg = warp_perspective(img * mask, H)
            wmask = warp_perspective(mask, H)
            paint = wmask > 0.5
            out[paint] = wimg[paint] / wmask[paint]
    return out


class PhotoSequence:
    """A camera path rendered from one photograph. Trajectories:

      "sweep"    monotone yaw + sideways/forward drift (the
                 test_real_texture 56-frame path generalized)
      "loop"     out-and-back: the second half retraces the first in
                 reverse, so the final frames REVISIT the starting views —
                 the return-to-start loop-closure scenario on photographic
                 imagery (VERDICT r3 item 6)
    """

    def __init__(self, img: np.ndarray, num_frames: int = 100,
                 trajectory: str = "loop", yaw_step_deg: float = 0.06,
                 t_step=(-0.004, 0.0008, 0.001),
                 depths=((1.0, 1.35), (1.6, 1.15))):
        from visualslam.geometry import se3
        import jax.numpy as jnp

        self.img = np.asarray(img, np.float32)
        h, w = self.img.shape
        f = float(w)
        self.K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
        self.intrinsics = np.array([f, f, w / 2, h / 2], np.float32)
        self.depths = np.asarray(depths, np.float64)
        self.poses = []          # (R, t) world-to-camera
        n = num_frames
        for k in range(n):
            if trajectory == "loop":
                half = (n - 1) / 2.0
                s = k if k <= half else (n - 1 - k)
            else:
                s = k
            ang = np.radians(yaw_step_deg * s)
            R = np.asarray(se3.exp_so3(jnp.asarray([0.0, ang, 0.0])),
                           np.float64)
            t = np.asarray(t_step, np.float64) * s
            self.poses.append((R, t))

    def __len__(self) -> int:
        return len(self.poses)

    def frame(self, k: int) -> np.ndarray:
        R, t = self.poses[k]
        if k == 0 or (np.allclose(R, np.eye(3)) and np.allclose(t, 0)):
            return self.img.copy()
        return warp_piecewise_planar(self.img, self.K, R, t,
                                     self.depths).astype(np.float32)

    def gt_poses(self) -> np.ndarray:
        """[N, 3, 4] camera-to-world (KITTI convention)."""
        out = []
        for R, t in self.poses:
            out.append(np.concatenate([R.T, (-R.T @ t)[:, None]], 1))
        return np.stack(out).astype(np.float32)
