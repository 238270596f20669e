"""Sec 4.3: learnable f-distance matrices on tree metrics.

Given a graph G and a spanning tree T, learn a rational f so that
f(d_T(v,w)) ~= d_G(v,w), training on a tiny sample of vertex pairs
(O(100) data points, as in the paper) and evaluating with the relative
Frobenius error eps = ||M_f^T - M_id^G||_F / ||M_id^G||_F.

The reference's `repro.core.fit`, step for step: the same pairs from the
same seed, the same float32 loss, the port's AdamW (`optim/adamw.py`) with
the reference's config. The training runs on `device` (None = the card).
The Frobenius errors read the all-pairs distances; callers that hold them
already pass them as `dists=(D_t, D_g)`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.graph import Graph, WeightedTree
from repro_torch.graphs.mst import minimum_spanning_tree
from repro_torch.graphs.traverse import (TreeLCA, dijkstra, graph_all_pairs,
                                         tree_all_pairs)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


def rational_apply(params, x):
    """f(x) = poly(num)(x) / (softplus-stabilized poly(den)(x)); softplus
    as log(1 + e^d) = logaddexp(d, 0), the reference's form."""
    num, den = params["num"], params["den"]
    n = torch.zeros_like(x)
    for c in num.flip(0):
        n = n * x + c
    d = torch.zeros_like(x)
    for c in den.flip(0):
        d = d * x + c
    return n / (1e-6 + torch.logaddexp(d, torch.zeros_like(d)))


def sample_training_pairs(g: Graph, tree: WeightedTree, num_pairs: int,
                          seed: int = 0):
    """Tuples (v, w, d_G(v,w), d_T(v,w)). d_G from Dijkstra on sampled
    sources (each data point is O(N log N), as the paper notes)."""
    rng = np.random.default_rng(seed)
    lca = TreeLCA(tree)
    srcs = rng.integers(0, g.num_vertices, size=max(1, num_pairs // 8))
    vs, ws, dg = [], [], []
    per_src = int(np.ceil(num_pairs / srcs.size))
    for s in srcs:
        dist_s = dijkstra(g, int(s))
        tgts = rng.integers(0, g.num_vertices, size=per_src)
        for t in tgts:
            if t == s:
                continue
            vs.append(int(s))
            ws.append(int(t))
            dg.append(dist_s[t])
    vs, ws = np.array(vs), np.array(ws)
    dt = lca.distance(vs, ws)
    return vs, ws, np.array(dg), dt


@dataclasses.dataclass
class FitResult:
    params: dict
    losses: np.ndarray
    rel_frobenius: float | None = None


def fit_rational_f(g: Graph, tree: WeightedTree | None = None,
                   num_deg: int = 2, den_deg: int = 2, num_pairs: int = 100,
                   steps: int = 500, lr: float = 5e-2, seed: int = 0,
                   eval_frobenius: bool = False, device=None,
                   dists=None) -> FitResult:
    """Fit the rational f on `num_pairs` sampled pairs for `steps` AdamW
    steps; `losses[i]` is the loss at the params before step i. With
    `eval_frobenius`, also the relative Frobenius error of the fit (over
    `dists=(D_t, D_g)` when given, else computed)."""
    dev = resolve_device(device)
    if tree is None:
        tree = minimum_spanning_tree(g)
    vs, ws, d_g, d_t = sample_training_pairs(g, tree, num_pairs, seed)
    scale = max(float(d_t.max()), 1e-9)
    xs = torch.as_tensor(np.asarray(d_t / scale, np.float32), device=dev)
    ys = torch.as_tensor(np.asarray(d_g / scale, np.float32), device=dev)

    params = {
        "num": torch.as_tensor(np.asarray(
            np.r_[0.0, 1.0, np.zeros(max(num_deg - 1, 0))], np.float32),
            device=dev).requires_grad_(True),
        "den": torch.as_tensor(np.asarray(
            np.r_[1.0, np.zeros(den_deg)], np.float32),
            device=dev).requires_grad_(True),
    }
    cfg = AdamWConfig(lr=lr, weight_decay=0.0, warmup_steps=10,
                      total_steps=steps, clip_norm=10.0)
    state = adamw_init(params)

    losses = []
    for _ in range(steps):
        loss = torch.mean((rational_apply(params, xs) - ys) ** 2)
        grads = torch.autograd.grad(loss, list(params.values()))
        state, _ = adamw_update(dict(zip(params, grads)), state, params, cfg)
        losses.append(float(loss.detach()))

    res = FitResult(params={k: v.detach().cpu().numpy()
                            for k, v in params.items()},
                    losses=np.array(losses))
    if eval_frobenius:
        res.rel_frobenius = relative_frobenius_error(g, tree, res.params,
                                                     scale, device=dev,
                                                     dists=dists)
    return res


def _dists(g, tree, dists):
    return dists if dists is not None else (tree_all_pairs(tree),
                                            graph_all_pairs(g))


def relative_frobenius_error(g: Graph, tree: WeightedTree, params,
                             scale: float, device=None, dists=None) -> float:
    """eps = ||f(D_T) - D_G||_F / ||D_G||_F (O(N^2): evaluation only). f is
    evaluated in float32 on `device` (None = the card), the norms in
    float64 on the host, as in the reference."""
    dev = resolve_device(device)
    D_t, D_g = _dists(g, tree, dists)
    p = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
         for k, v in params.items()}
    x = torch.as_tensor((D_t / scale).astype(np.float32), device=dev)
    pred = rational_apply(p, x).cpu().numpy()
    return float(np.linalg.norm(pred * scale - D_g) / np.linalg.norm(D_g))


def tree_metric_frobenius_error(g: Graph, tree: WeightedTree,
                                dists=None) -> float:
    """Baseline: identity f (raw tree metric) error."""
    D_t, D_g = _dists(g, tree, dists)
    return float(np.linalg.norm(D_t - D_g) / np.linalg.norm(D_g))
