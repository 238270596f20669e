"""The Mamba-1 selective scan: the CUDA kernel (selective_scan.cu,
kernel.py), its plain chunked version and wrapper (ops.py) and the
sequential oracle (ref.py)."""
