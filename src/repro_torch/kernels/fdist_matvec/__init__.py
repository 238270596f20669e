"""Fused f-distance matvec: out[n, i] = sum_j f(x[n, i] + y[n, j]) V[n, j]."""
