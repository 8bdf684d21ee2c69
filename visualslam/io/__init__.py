from visualslam.io.kitti import (  # noqa: F401
    KittiOdometrySequence,
    SequenceInfo,
    SyntheticSequence,
)
from visualslam.io.serialization import (  # noqa: F401
    load_descriptors_dat,
    load_kitti_poses,
    save_descriptors_dat,
    save_kitti_poses,
)
