"""Fused topological masked linear attention: the CUDA sweep kernel
(topo_sweep.cu, kernel.py), its plain version and wrapper (ops.py) and the
dense oracle (ref.py)."""
