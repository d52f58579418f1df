"""Parallel support of the port: the npz checkpoints (``checkpoint``) and
the device mesh of tensor-parallel serving (``mesh``)."""
