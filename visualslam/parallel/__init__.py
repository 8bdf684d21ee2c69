from visualslam.parallel.mesh import make_mesh  # noqa: F401
