"""eps = F·w − b with sign labels and the positive count in one pass over
F: CUDA kernel (`kernel.py`), public wrapper (`ops.py`), plain version
(`ref.py`)."""
