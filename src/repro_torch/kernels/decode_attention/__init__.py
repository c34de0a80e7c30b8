"""Single-token GQA attention over a KV cache: CUDA kernel (`kernel.py`),
public wrapper in the model layout (`ops.py`), plain version (`ref.py`)."""
