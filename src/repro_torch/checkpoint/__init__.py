"""Checkpoints of the port: atomic, keep-k, resumable."""
