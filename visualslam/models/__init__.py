from visualslam.models.types import Features, Keypoints, Matches  # noqa: F401
from visualslam.models.pyramid import ScaleSpace, build_pyramid, build_pyramid_jit  # noqa: F401
from visualslam.models.harris import detect_harris, detect_harris_jit  # noqa: F401
from visualslam.models.sift import (  # noqa: F401
    detect_and_describe_sift,
    detect_and_describe_sift_jit,
)
from visualslam.models.orb import (  # noqa: F401
    detect_and_describe_orb,
    detect_and_describe_orb_jit,
)
from visualslam.models.matching import match_features, match_features_jit  # noqa: F401
