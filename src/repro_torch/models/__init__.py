"""Models of the port: the Topological Transformer LM (dense family,
attention_variant="topo") and its serving entry points (api.py)."""
