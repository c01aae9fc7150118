"""PyTorch + CUDA port of the Leap tiered paged-KV serving path.

This package mirrors :mod:`repro` (the JAX reference) module for module
where that helps a reader find a counterpart, but it imports ``torch`` only:
never ``jax`` and nothing of the ``repro`` package. The pieces it needs
from framework-neutral modules of the reference (the trace schema, the
registry, the request state machine, the page allocator, the arrival
process) are kept as copies here.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that request it raises (see
:mod:`repro_torch.device`). The hand-written Hopper kernels live under
:mod:`repro_torch.kernels` and build at first use with ``nvcc``; the model
code (dense family) under :mod:`repro_torch.models`, its configs under
:mod:`repro_torch.configs`.
"""

__all__ = ["__version__"]

__version__ = "0.1.0"
