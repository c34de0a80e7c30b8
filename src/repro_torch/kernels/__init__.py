"""Hand-written Hopper kernels of the port, one subpackage each:

  kernel.py — launch wrapper of the CUDA source in `repro_torch/csrc/`
  ops.py    — public wrapper (window alignment, dispatch on device)
  ref.py    — plain PyTorch version (the CPU path and the kernel's check)

`build.py` compiles the CUDA sources with nvcc and loads them with ctypes.
"""
