"""The reference's example entry points on the port, each a module with
`main(argv=None) -> dict` that prints what the reference's script prints
and returns its numbers:

    python -m repro_torch.examples.quickstart            # FTFI, the facade
    python -m repro_torch.examples.mesh_interpolation    # Fig. 4's normals
    python -m repro_torch.examples.serve_lm              # batched serving
    python -m repro_torch.examples.train_topological_lm  # Table 1, LM scale

Each runs on the CUDA card by default and raises without one;
`--device cpu` runs it on the CPU."""
