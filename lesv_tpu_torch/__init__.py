"""lesv_tpu_torch: the PyTorch/CUDA port of lesv_tpu for NVIDIA Hopper.

The ``map`` stage (seeding, chaining, candidate windows, pair seeding,
anchored banded alignment, M4 records) runs on an explicit torch device.
Its three hot loops are hand-written CUDA kernels under ``csrc/`` (banded
fill, chain scan, traceback), built with ``nvcc`` at first use; every
kernel has a plain PyTorch version beside it, used for CPU tensors.
The JAX package ``lesv_tpu`` is the reference; this package imports only
its JAX-free host modules.
"""
