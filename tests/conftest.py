"""Test environment: the CPU backend with 8 virtual devices, so mesh /
shard_map / psum paths run without accelerators (SURVEY.md §4
implication (4)). Must run before jax is imported anywhere. Tests that
need a GPU carry the `gpu` marker and decide inside the test whether one
is present."""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# pin the platform in config as well as in the environment, before any
# backend is initialized: a GPU present on the host must not be picked up
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_IMAGES = "/root/reference/KeyPointDetection/images"


@pytest.fixture()
def rng():
    # function-scoped: every test gets the same deterministic stream
    # regardless of which other tests ran before it
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def blox():
    """256x256 bundled test image (reference C9), as float32 [0,1]."""
    from visualslam.utils.images import load_gray

    return load_gray(os.path.join(REFERENCE_IMAGES, "blox.jpg"))


@pytest.fixture(scope="session")
def home():
    """512x384 bundled test image used by the reference DoG main
    (Diff_of_Gauss.cpp:730)."""
    from visualslam.utils.images import load_gray

    return load_gray(os.path.join(REFERENCE_IMAGES, "home.jpg"))
