from visualslam.geometry.camera import normalized, project, unproject  # noqa: F401
from visualslam.geometry.epipolar import (  # noqa: F401
    decompose_essential,
    eight_point,
    recover_pose,
    sampson_error,
    triangulate,
)
from visualslam.geometry.ransac import estimate_relative_pose, ransac_essential  # noqa: F401
from visualslam.geometry import se3  # noqa: F401
