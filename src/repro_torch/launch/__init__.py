"""Launchers of the port: `serve.py` (LM decode serving)."""
