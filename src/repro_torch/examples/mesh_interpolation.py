"""Paper Sec 4.2: vertex-normal interpolation on meshes.

Mask 80% of vertex normals; reconstruct them by f-integrating the known
ones over the mesh MST with the rational kernel f(x) = 1/(1 + lambda x^2).

    python -m repro_torch.examples.mesh_interpolation [--device cpu]

The reference's examples/mesh_interpolation.py on the port, on the same
"host" backend (the recursive FTFI walk in numpy); the field, the
predictions and the cosine live on the device."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import Integrator, Rational
from repro_torch.device import resolve_device
from repro_torch.graphs.meshes import icosphere, mesh_graph, vertex_normals
from repro_torch.graphs.mst import minimum_spanning_tree


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    result = {}
    for subdiv in (3, 4):
        verts, faces = icosphere(subdiv)
        n = verts.shape[0]
        normals = vertex_normals(verts, faces)
        mst = minimum_spanning_tree(mesh_graph(verts, faces))

        known = rng.random(n) < 0.2  # keep 20%, mask 80% (paper protocol)
        F = torch.as_tensor(np.where(known[:, None], normals, 0.0),
                            device=dev)
        unknown = torch.as_tensor(~known, device=dev)
        truth = torch.as_tensor(normals, device=dev)[unknown]

        t0 = time.perf_counter()
        integ = Integrator(mst, backend="host", leaf_size=256)
        t_pre = time.perf_counter() - t0

        best = (-1.0, None)
        for lam in (1.0, 4.0, 16.0):  # grid search as in the paper
            pred = integ.integrate(Rational((1.0,), (1.0, 0.0, lam)), F)
            pred = pred / pred.norm(dim=1, keepdim=True).clamp_min(1e-12)
            cos = float((pred[unknown] * truth).sum(dim=1).mean())
            if cos > best[0]:
                best = (cos, lam)
        result[subdiv] = {"n": n, "preprocess_ms": t_pre * 1e3,
                          "cosine": best[0], "lambda": best[1]}
        print(f"icosphere/{subdiv}: n={n:6d} preprocess={t_pre*1e3:7.1f} ms"
              f"  cosine={best[0]:.4f} (lambda={best[1]})")
    return result


if __name__ == "__main__":
    main()
