from visualslam.backend.ba import BAProblem, BAResult, run_ba, run_ba_jit  # noqa: F401
