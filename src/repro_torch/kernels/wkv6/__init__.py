"""RWKV-6 chunked WKV recurrence: CUDA kernel (`kernel.py`), public
wrapper in the model layout (`ops.py`), plain versions (`ref.py`)."""
