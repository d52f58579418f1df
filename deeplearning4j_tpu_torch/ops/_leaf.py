"""The audit's seam at the hand-written kernels' entry points.

``HOOK`` is None unless ``analysis/audit.py`` is tracing a program family:
each kernel's dispatcher (flash forward #1, decode #3, paged decode #4,
the threefry draw) then hands its call to ``HOOK(name, plain, *args)``,
which records the kernel as one op at the flops and bytes of its bound
and returns the plain version's outputs (computed with the recorder off,
on ``meta`` tensors). Off, it costs each launch one global load and one
``None`` check.
"""

HOOK = None
