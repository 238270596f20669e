"""Models of the port: the dense decoder LM with full, Performer or
topological attention, and its serving entry points (api.py)."""
