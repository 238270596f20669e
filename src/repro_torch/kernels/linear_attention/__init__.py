"""Causal (gamma-decayed) linear attention: the CUDA kernel
(linear_attention.cu, kernel.py), its plain version and wrapper (ops.py)
and the dense oracle (ref.py)."""
