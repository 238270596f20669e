"""Flash attention forward: the CUDA kernel (flash_attention.cu, kernel.py),
its plain version and wrapper (ops.py) and the dense oracle (ref.py)."""
