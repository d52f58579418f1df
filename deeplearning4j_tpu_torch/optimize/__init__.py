"""Optimization subsystem of the port (the JAX package's ``optimize/``):
updaters, line search, the convex solvers and their listeners."""

from deeplearning4j_tpu_torch.optimize.solver import Solver  # noqa: F401
