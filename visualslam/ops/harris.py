"""Harris corner response.

Reference: per-pixel structure-tensor accumulation + response scan
(Harris_corners.cpp:10-29 `StructureMatrix`, 31-68 `HarrisCorner` — the hot
loops, SURVEY.md §2.1). Array form: the 3x3 accumulation of Ix², Iy²,
IxIy is a box filter (two 1-D convs), and the response is elementwise —
one fused XLA program over the whole image, no pixel loops.
"""

from __future__ import annotations

import jax.numpy as jnp

from visualslam.ops.blur import box_filter


def harris_response(dx: jnp.ndarray, dy: jnp.ndarray, window: int = 3,
                    k: float = 0.04) -> jnp.ndarray:
    """R = det(M) - k*tr(M)^2 with M the window-summed structure tensor.

    dx, dy: [..., H, W] image gradients (ref feeds Sobel ksize=1 outputs,
    Harris_corners.cpp:163-164). Matches ref response at :54-58."""
    ixx = box_filter(dx * dx, window)
    iyy = box_filter(dy * dy, window)
    ixy = box_filter(dx * dy, window)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * (tr * tr)
