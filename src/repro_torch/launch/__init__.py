"""Launchers of the port: `serve.py` (LM decode serving), `train.py`
(training, on one device or a `torch.distributed` mesh), `mesh.py` (the
meshes and the process group)."""
