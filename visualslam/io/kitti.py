"""KITTI-odometry-style dataset IO (SURVEY.md §2.3 "Dataset IO").

Layout expected (standard KITTI odometry):
    root/sequences/<seq>/image_0/*.png   grayscale frames
    root/sequences/<seq>/calib.txt       P0..P3 projection matrices
    root/sequences/<seq>/times.txt       per-frame timestamps
    root/poses/<seq>.txt                 ground-truth 3x4 poses (optional)

Also provides a synthetic sequence generator with the same interface so the
full pipeline can run end-to-end (and be benchmarked) without the dataset on
disk. Images load via PIL host-side; the C++ prefetcher (native/) can be
swapped in for the decode path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from visualslam.io.serialization import load_kitti_poses


@dataclass
class SequenceInfo:
    name: str
    num_frames: int
    intrinsics: np.ndarray          # [4] fx, fy, cx, cy
    image_size: tuple[int, int]     # (H, W)
    gt_poses: Optional[np.ndarray]  # [F, 3, 4] camera-to-world or None
    times: Optional[np.ndarray]


class KittiOdometrySequence:
    """Lazy frame loader for one KITTI odometry sequence."""

    def __init__(self, root: str, seq: str, camera: int = 0):
        self.root = root
        self.seq = seq
        self.dir = os.path.join(root, "sequences", seq)
        self.img_dir = os.path.join(self.dir, f"image_{camera}")
        self.files = sorted(
            f for f in os.listdir(self.img_dir) if f.endswith(".png"))
        P = self._read_calib()[camera]
        self.intrinsics = np.array([P[0, 0], P[1, 1], P[0, 2], P[1, 2]],
                                   np.float32)
        pose_file = os.path.join(root, "poses", f"{seq}.txt")
        self.gt_poses = (load_kitti_poses(pose_file)
                         if os.path.exists(pose_file) else None)
        times_file = os.path.join(self.dir, "times.txt")
        self.times = (np.loadtxt(times_file)
                      if os.path.exists(times_file) else None)
        first = self.frame(0)
        self.image_size = first.shape

    def _read_calib(self) -> dict[int, np.ndarray]:
        out = {}
        with open(os.path.join(self.dir, "calib.txt")) as f:
            for line in f:
                if not line.strip():
                    continue
                key, vals = line.split(":", 1)
                if key.startswith("P"):
                    out[int(key[1:])] = np.fromstring(
                        vals, sep=" ").reshape(3, 4)
        return out

    def __len__(self) -> int:
        return len(self.files)

    def frame(self, i: int) -> np.ndarray:
        path = os.path.join(self.img_dir, self.files[i])
        from visualslam.io import native

        if native.available():
            return native.decode_gray(path)
        from PIL import Image

        img = Image.open(path).convert("L")
        return np.asarray(img, np.float32) / 255.0

    def frames(self) -> Iterator[np.ndarray]:
        """Iterate frames; uses the native multithreaded prefetcher (decode
        runs ahead of the SLAM loop) when the C++ runtime is built."""
        from visualslam.io import native

        if native.available():
            paths = [os.path.join(self.img_dir, f) for f in self.files]
            pf = native.Prefetcher(paths, capacity=8, n_threads=4)
            try:
                yield from pf
            finally:
                pf.close()
            return
        for i in range(len(self)):
            yield self.frame(i)

    def info(self) -> SequenceInfo:
        return SequenceInfo(self.seq, len(self), self.intrinsics,
                            self.image_size, self.gt_poses, self.times)


class SyntheticSequence:
    """Rendered synthetic sequence: textured random-dot world projected onto
    a moving pinhole camera. Interface-compatible with
    KittiOdometrySequence so the SLAM CLI/benchmarks run with no dataset.

    The scene is a textured corridor (ground plane + two side walls carrying
    tiled band-limited noise, raycast per frame with distance fade) plus a
    cloud of Gaussian splats at varied depths. The dense surface texture
    makes detection repeatable under viewpoint change (real imagery is
    texture-rich everywhere — a splats-only world starves the contrast
    threshold and tracking collapses for scene-content reasons); the splats
    and the plane geometry give real parallax."""

    def __init__(self, num_frames: int = 50, h: int = 240, w: int = 376,
                 n_dots: int = 1500, seed: int = 0, step: float = 0.4,
                 textured: bool = True, trajectory: str = "dolly",
                 yaw_rate: float = 0.01, laps: int = 1):
        """trajectory: "dolly" (forward along +z with mild yaw — the
        default), "arc" (heading-following turn, yaw_rate rad/frame —
        exercises rotation accuracy), "loop" (strafe rectangle returning
        to the start viewpoint with the same heading — exercises loop
        closure/relocalization). laps: number of rectangle circuits the
        "loop" trajectory completes within num_frames — laps >= 2 makes
        every frame of the later laps a true revisit of the first, so
        multiple loop closures can fire."""
        self.num_frames = num_frames
        rng = np.random.default_rng(seed)
        self.h, self.w = h, w
        self.textured = textured
        self.trajectory = trajectory
        self.yaw_rate = yaw_rate
        self.laps = max(1, laps)
        if textured:
            self.tex = self._make_texture(rng, 512)
        f = 0.6 * w
        self.intrinsics = np.array([f, f, w / 2, h / 2], np.float32)
        self.X = rng.uniform([-30, -15, 15], [30, 15, 60], (n_dots, 3))
        # anisotropic signed splats: random orientation/eccentricity and
        # bright/dark mix give each landmark a distinctive local gradient
        # structure (identical isotropic blobs all share one descriptor and
        # matching collapses after a frame or two of viewpoint change)
        self.amp = (rng.uniform(0.3, 0.85, n_dots)
                    * rng.choice([-1.0, 1.0], n_dots)).astype(np.float32)
        self.rad = rng.uniform(1.5, 4.0, n_dots).astype(np.float32)
        self.ecc = rng.uniform(1.0, 2.5, n_dots).astype(np.float32)
        theta = rng.uniform(0, np.pi, n_dots).astype(np.float32)
        self.cos_t = np.cos(theta)
        self.sin_t = np.sin(theta)
        self.step = step
        self._yaws, self._centers = self._make_path()
        self.gt_poses = np.stack([self._pose_cw(k)
                                  for k in range(num_frames)])
        self.times = np.arange(num_frames) * 0.1
        self.image_size = (h, w)

    _TILE = 64.0        # world units spanned by one texture tile

    @staticmethod
    def _make_texture(rng, n: int) -> list:
        """Tileable multi-octave value noise: one random grid per octave
        (8..256 cells over a 64-world-unit tile). Octaves are sampled
        SEPARATELY at render time so each can be attenuated by the pixel's
        world-space footprint — an analytic mipmap; plain bilinear sampling
        under minification would alias and decorrelate between frames,
        destroying detection repeatability."""
        octaves = []
        amp = 1.0
        for res in (8, 16, 32, 64, 128, 256):
            octaves.append((rng.normal(size=(res, res)).astype(np.float32),
                            amp))
            amp *= 0.78
        norm = 0.38 / sum(a for _, a in octaves)
        return [(g, a * norm * 3.0) for g, a in octaves]

    def _sample_tex(self, a: np.ndarray, b: np.ndarray,
                    footprint: np.ndarray) -> np.ndarray:
        """Mip-attenuated octave-sum sample at world coords (a, b).
        footprint: per-sample world-units-per-pixel on the surface."""
        out = np.zeros(a.shape, np.float32)
        for g, amp in self.tex:
            res = g.shape[0]
            cell = self._TILE / res
            # attenuate octaves whose cells are below ~1.5 px on screen
            w = np.clip(cell / np.maximum(footprint, 1e-6) - 0.5, 0.0, 1.0)
            if not w.any():
                continue
            ua = a * (res / self._TILE)
            ub = b * (res / self._TILE)
            i0 = np.floor(ua).astype(np.int64)
            j0 = np.floor(ub).astype(np.int64)
            fa = (ua - i0).astype(np.float32)
            fb = (ub - j0).astype(np.float32)
            i0 %= res
            j0 %= res
            i1 = (i0 + 1) % res
            j1 = (j0 + 1) % res
            out += amp * w * (
                g[i0, j0] * (1 - fa) * (1 - fb) + g[i1, j0] * fa * (1 - fb)
                + g[i0, j1] * (1 - fa) * fb + g[i1, j1] * fa * fb)
        return out

    def _background(self, R: np.ndarray, t: np.ndarray) -> np.ndarray:
        """Raycast the textured corridor (ground y=+10, walls x=±18) for a
        camera at world-to-camera (R, t)."""
        fx, fy, cx, cy = self.intrinsics
        C = -R.T @ t                                  # camera center, world
        vv, uu = np.mgrid[0:self.h, 0:self.w].astype(np.float32)
        d_c = np.stack([(uu - cx) / fx, (vv - cy) / fy,
                        np.ones_like(uu)], axis=-1).reshape(-1, 3)
        d_w = d_c @ R                                 # R^T d per row
        eps = 1e-9
        best_s = np.full(d_w.shape[0], np.inf, np.float32)
        val = np.zeros(d_w.shape[0], np.float32)
        planes = ((1, 10.0, 0, 2), (0, 18.0, 1, 2), (0, -18.0, 1, 2))
        for axis, off, ta, tb in planes:
            da = d_w[:, axis]
            s = (off - C[axis]) / np.where(np.abs(da) < eps, eps, da)
            hit = (s > 0.5) & (s < best_s)
            if not hit.any():
                continue
            p = C[None, :] + s[hit, None] * d_w[hit]
            # world-units-per-pixel at distance s (isotropic approximation)
            fp = s[hit] / float(fx)
            val[hit] = self._sample_tex(p[:, ta], p[:, tb], fp)
            best_s[hit] = s[hit]
        return (0.5 + val).reshape(self.h, self.w)

    @staticmethod
    def _yaw_R(a: float) -> np.ndarray:
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])

    def _make_path(self):
        """Per-frame (yaw, camera-center) arrays for the trajectory mode."""
        n = self.num_frames
        ks = np.arange(n, dtype=np.float64)
        if self.trajectory == "arc":
            # heading-following turn: the camera looks where it goes
            yaws = self.yaw_rate * ks
            centers = np.zeros((n, 3))
            for k in range(1, n):
                d = self._yaw_R(yaws[k - 1]).T @ np.array([0, 0, self.step])
                centers[k] = centers[k - 1] + d
            return yaws, centers
        if self.trajectory == "loop":
            # strafe rectangle, constant heading: forward, right, back,
            # left — the final frames re-see the first frames' view
            q = max(n // (4 * self.laps), 1)
            depth = self.step * q
            width = min(6.0, 0.2 * q)
            centers = np.zeros((n, 3))
            for k in range(1, n):
                p = k % (4 * q)
                if p < q:
                    d = [0, 0, self.step]
                elif p < 2 * q:
                    d = [width / q, 0, 0]
                elif p < 3 * q:
                    d = [0, 0, -self.step]
                else:
                    d = [-width / q, 0, 0]
                centers[k] = centers[k - 1] + np.asarray(d)
            return np.zeros(n), centers
        # "dolly": gentle forward path with mild yaw (the default)
        yaws = 0.003 * ks
        centers = np.stack([0.02 * ks, np.zeros(n), self.step * ks], -1)
        return yaws, centers

    def _pose_wc(self, k):
        R = self._yaw_R(self._yaws[k])
        center = self._centers[k]
        return R.astype(np.float64), (-R @ center).astype(np.float64)

    def _pose_cw(self, k):
        R, t = self._pose_wc(k)
        return np.concatenate([R.T, (-R.T @ t)[:, None]], axis=1)

    def __len__(self) -> int:
        return self.num_frames

    def frame(self, k: int) -> np.ndarray:
        R, t = self._pose_wc(k)
        Xc = self.X @ R.T + t
        z = Xc[:, 2]
        vis = z > 1.0
        fx, fy, cx, cy = self.intrinsics
        u = fx * Xc[:, 0] / np.maximum(z, 1e-6) + cx
        v = fy * Xc[:, 1] / np.maximum(z, 1e-6) + cy
        if self.textured:
            img = self._background(R.astype(np.float32),
                                   t.astype(np.float32))
        else:
            img = np.full((self.h, self.w), 0.5, np.float32)
        sel = vis & (u > -8) & (u < self.w + 8) & (v > -8) & (v < self.h + 8)
        if sel.any():
            # vectorized anisotropic Gaussian splatting, 11x11 stencil
            yy, xx = np.mgrid[-5:6, -5:6]
            us, vs = u[sel], v[sel]
            iu = np.round(us).astype(np.int64)
            iv = np.round(vs).astype(np.int64)
            r_px = np.maximum(self.rad[sel] * 20.0 / z[sel], 0.8)
            dy = yy[None] + (iv - vs)[:, None, None]          # [n, 11, 11]
            dx = xx[None] + (iu - us)[:, None, None]
            ct = self.cos_t[sel][:, None, None]
            st = self.sin_t[sel][:, None, None]
            a = dx * ct + dy * st                  # major axis
            b = -dx * st + dy * ct                 # minor axis
            ecc2 = self.ecc[sel][:, None, None] ** 2
            g = self.amp[sel][:, None, None] * np.exp(
                -(a * a + b * b * ecc2) / (2 * r_px[:, None, None] ** 2))
            ys = np.clip(iv[:, None, None] + yy[None], 0, self.h - 1)
            xs = np.clip(iu[:, None, None] + xx[None], 0, self.w - 1)
            np.add.at(img, (ys.ravel(), xs.ravel()),
                      g.ravel().astype(np.float32))
            np.clip(img, 0.02, 1.0, out=img)
        return img

    def frames(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self.frame(i)

    def info(self) -> SequenceInfo:
        return SequenceInfo("synthetic", self.num_frames, self.intrinsics,
                            self.image_size, self.gt_poses, self.times)
