"""Union-band relabel of k views over one shared table: CUDA kernel
(`kernel.py`), public wrapper (`ops.py`), plain version (`ref.py`)."""
