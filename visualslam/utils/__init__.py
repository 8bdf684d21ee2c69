from visualslam.utils.config import (  # noqa: F401
    BAConfig,
    DEFAULT_CONFIG,
    HarrisConfig,
    MatchConfig,
    OrbConfig,
    PoseGraphConfig,
    PyramidConfig,
    RansacConfig,
    SiftConfig,
    SlamConfig,
)
from visualslam.utils.masked import (  # noqa: F401
    compact,
    masked_mean,
    merge,
    top_k_select,
)
