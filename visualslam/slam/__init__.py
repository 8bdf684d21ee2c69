from visualslam.slam.two_view import (  # noqa: F401
    TwoViewResult,
    two_view_from_features,
    two_view_reconstruction,
    two_view_reconstruction_jit,
)
