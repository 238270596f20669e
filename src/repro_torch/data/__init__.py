"""Data of the port: the reference's deterministic synthetic LM stream."""
