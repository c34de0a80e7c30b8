"""Causal GQA attention forward: CUDA kernel (`kernel.py`), public wrapper
in the model layout (`ops.py`), plain version (`ref.py`)."""
