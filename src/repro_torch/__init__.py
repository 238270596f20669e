"""PyTorch/CUDA port of the FTFI reproduction (see ROADMAP.md).

Host-side numpy builds the plan (graphs -> MST -> IT decomposition ->
bucketed plan); PyTorch executes it, with the cross multiply of the
in-kernel f families on a hand-written CUDA kernel for Hopper. Imports
neither jax nor the reference package `repro`.
"""
