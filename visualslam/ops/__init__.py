from visualslam.ops.blur import blur_stack, box_filter, gaussian_blur, gaussian_taps  # noqa: F401
from visualslam.ops.gradients import central_diff, gradients, magnitude_orientation  # noqa: F401
from visualslam.ops.harris import harris_response  # noqa: F401
from visualslam.ops.nms import window_max, window_peaks  # noqa: F401
from visualslam.ops.resize import downsample2x_nearest, upsample2x_linear  # noqa: F401
