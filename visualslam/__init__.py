"""visualslam: a visual SLAM / SfM engine in JAX/XLA/Pallas.

Built from scratch against the capability surface of the reference CPU
pipeline (JacobYoung115/VisualSLAM, see SURVEY.md): Gaussian scale-space
pyramids, Harris + DoG/SIFT keypoint detection, SIFT/ORB description,
descriptor matching, epipolar two-view reconstruction, sliding-window
bundle adjustment, and pose-graph optimization — with shard_map
distribution over device meshes.

Package layout (SURVEY.md §7 build plan):
  utils/     config tree, masked fixed-capacity sets, padding, profiling
  ops/       compute kernels (XLA + Pallas): blur, gradients, NMS, histograms,
             descriptor sampling, distance matrices
  models/    pyramid builder + detector/descriptor frontends (Harris, SIFT, ORB)
  geometry/  SE(3), epipolar geometry, RANSAC, triangulation
  backend/   bundle adjustment (Schur/GN), pose-graph optimization
  parallel/  mesh/sharding helpers, distributed BA assembly
  slam/      tracking loop, keyframe policy, map state, checkpointing
  io/        dataset IO (KITTI-style), serialization, native bindings
"""

__version__ = "0.2.0"

import os as _os

import jax as _jax

_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def configure_compile_cache(environ=_os.environ, platforms=None):
    """Persistent XLA compilation cache. A program compiles once per
    checkout; later processes load it from disk instead of compiling
    again (the engine's batch program takes tens of seconds to compile).

    The directory is $JAX_COMPILATION_CACHE_DIR when set (JAX reads it
    itself), else the fixed <checkout>/.jax_cache: the path is part of the
    cache key, so it must not move between runs. CPU-only processes get no
    default cache: XLA:CPU's cached kernels carry machine-feature strings
    that do not round-trip, and CPU compiles are fast. Returns the
    directory in use, or None."""
    cache = environ.get("JAX_COMPILATION_CACHE_DIR")
    if cache is None:
        if platforms is None:
            platforms = str(_jax.config.jax_platforms or "")
        if platforms.split(",")[0] == "cpu":
            return None
        cache = _os.path.join(_CHECKOUT, ".jax_cache")
        _jax.config.update("jax_compilation_cache_dir", cache)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return cache


configure_compile_cache()

from visualslam.utils.config import (  # noqa: F401
    PyramidConfig,
    HarrisConfig,
    SiftConfig,
    OrbConfig,
    MatchConfig,
    RansacConfig,
    BAConfig,
    SlamConfig,
)
