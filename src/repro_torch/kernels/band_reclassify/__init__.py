"""Band relabel, multi-view (union of k windows over one shared table) and
single-view (one row-granular window): CUDA kernels (`kernel.py`), public
wrappers (`ops.py`), plain versions (`ref.py`)."""
