"""Procedural 3D meshes and their edge graphs (Thingi10K substitute)."""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import Graph


def icosphere(subdivisions: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Returns (vertices (V,3), faces (F,3)) of a unit icosphere."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdivisions):
        verts, faces = _subdivide(verts, faces)
        verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    return verts, faces


def _subdivide(verts, faces):
    edge_mid: dict[tuple[int, int], int] = {}
    new_verts = list(verts)

    def midpoint(a, b):
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            edge_mid[key] = len(new_verts)
            new_verts.append((verts[a] + verts[b]) / 2.0)
        return edge_mid[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.array(new_verts), np.array(new_faces, dtype=np.int64)


def torus_mesh(major_n: int = 48, minor_n: int = 24, R: float = 1.0,
               r: float = 0.35) -> tuple[np.ndarray, np.ndarray]:
    """Parametric torus triangulation."""
    us = np.linspace(0, 2 * np.pi, major_n, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, minor_n, endpoint=False)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    x = (R + r * np.cos(vv)) * np.cos(uu)
    y = (R + r * np.cos(vv)) * np.sin(uu)
    z = r * np.sin(vv)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)
    faces = []
    for i in range(major_n):
        for j in range(minor_n):
            a = i * minor_n + j
            b = ((i + 1) % major_n) * minor_n + j
            c = i * minor_n + (j + 1) % minor_n
            d = ((i + 1) % major_n) * minor_n + (j + 1) % minor_n
            faces += [[a, b, c], [b, d, c]]
    return verts, np.array(faces, dtype=np.int64)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals from face normals."""
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norms = np.linalg.norm(vn, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return vn / norms


def mesh_graph(verts: np.ndarray, faces: np.ndarray) -> Graph:
    """Edge graph of a triangle mesh; weights = Euclidean edge lengths."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    w = np.linalg.norm(verts[e[:, 0]] - verts[e[:, 1]], axis=1)
    w = np.maximum(w, 1e-9)
    return Graph(verts.shape[0], e[:, 0], e[:, 1], w)
