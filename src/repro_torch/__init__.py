"""PyTorch/CUDA port of the HAZY k-view maintenance engine for one NVIDIA
H100, beside the JAX reference package `repro`.

Mirrors `repro`'s layout (`core/engine.py`, `core/sharded.py`,
`core/facade.py`, `kernels/band_reclassify/{kernel,ops,ref}.py`, ...), so
each module's reference sits at the same relative path. Imports torch and
numpy, never jax and nothing of `repro`. Entry points run on the GPU
unless the caller passes `device="cpu"`, which runs the plain PyTorch
versions of the kernels.
"""
