"""lesv_tpu_torch: the PyTorch/CUDA port of lesv_tpu for NVIDIA Hopper.

``run`` (reads to a VCF: split, map, SV-read selection, signatures,
grouping, group consensus, remap, call) and ``map`` run on an explicit
torch device.  The hot loops are hand-written CUDA kernels under
``csrc/`` (banded fill with int32 and with int16 state, chain scan,
traceback), built with ``nvcc`` at first use; every kernel has a plain
PyTorch version beside it, used for CPU tensors.  The JAX package
``lesv_tpu`` is the reference; this package imports nothing of it and
keeps its own copy of the host modules it needs (``convert`` carries
state across as plain arrays).
"""
