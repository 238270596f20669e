"""Models of the port: the decoder LM of the dense family (full,
Performer or topological attention) and of the ssm family (Mamba-1), and
its serving entry points (api.py)."""
