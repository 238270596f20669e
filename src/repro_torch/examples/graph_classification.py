"""Graph classification with f-distance spectral features (paper Sec 4.2).

    python -m repro_torch.examples.graph_classification [--device cpu]
        [--backend torch,cuda] [--n-per-class 20] [--size-range 24-60]

The reference's examples/graph_classification.py on the port, with the
pipeline it imports from the reference's benchmark code: the dataset
(three procedural families standing in for TUDatasets), the tree-kernel
features (the per-graph host loop and the packed forest path), the exact
graph-kernel features (BGFI) and the numpy classifier.

The forest path packs every graph's MST into one `Forest`: one fused plan
and one `integrate` on the block-diagonal identity field return every
graph's dense kernel M_f = [exp(LAM d_T(i, j))], and each graph's k
smallest eigenvalues are read off its own block on the host. Its backends
map as the facade maps them: the reference's "plan" is "torch", its
"pallas" is "cuda" (the fdist_matvec kernel, one launch per cross bucket
of the plan). A tree no larger than the plan's leaf size (64) is one dense
leaf, so the reference's sizes (24-59 vertices) give a plan with no cross
bucket; at D&D's sizes (`--size-range 30-540`) the kernel runs."""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from scipy.linalg.lapack import ssyevx

from repro_torch.core import Exponential, Forest, Integrator
from repro_torch.device import resolve_device
from repro_torch.graphs.graph import random_graph_family
from repro_torch.graphs.mst import (minimum_spanning_forest,
                                    minimum_spanning_tree)
from repro_torch.graphs.traverse import graph_all_pairs, tree_all_pairs

FAMILIES = ["ring_lattice", "pref_attach", "community"]
LAM = -0.5  # f(s) = exp(LAM * s): the de Lara & Pineau heat-kernel features
BACKENDS = ("torch", "cuda")


def _eigvals_smallest(M, k):
    """The k smallest eigenvalues of symmetric M by LAPACK's ssyevx, which
    computes only those (one triangle read)."""
    w, _, m, _, info = ssyevx(M, range="I", il=1, iu=k, compute_v=0)
    if info != 0 or m < k:  # pragma: no cover - degenerate fallback
        return np.linalg.eigvalsh(M)[:k]
    return w[:k]


def _kernel_spectrum(M, k=8):
    """k smallest eigenvalues of the f-distance kernel matrix M (symmetric
    by construction; only one triangle is read)."""
    M = np.asarray(M, dtype=np.float32)
    return _eigvals_smallest(M, min(k, M.shape[0]))


def make_dataset(n_per_class=30, size_range=(24, 60), seed=0):
    """n_per_class graphs of each family, of `rng.integers(*size_range)`
    vertices (the upper end excluded); labels are the family's index."""
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for ci, fam in enumerate(FAMILIES):
        for i in range(n_per_class):
            n = int(rng.integers(*size_range))
            graphs.append(random_graph_family(fam, n, seed * 977 + i))
            labels.append(ci)
    return graphs, np.array(labels)


def features_ftfi(graphs, k=8):
    """Per-graph host loop: Kruskal MST, all-pairs tree distances, exp and
    a float64 `eigvalsh` per graph. The features' reference and the
    baseline the forest path is timed against."""
    feats = []
    for g in graphs:
        D = tree_all_pairs(minimum_spanning_tree(g))
        M = np.exp(LAM * D)
        feats.append(np.linalg.eigvalsh(M.astype(np.float64))[:k])
    return np.array(feats)


def features_forest(graphs, k=8, backend="torch", device=None, stats=None):
    """Packed forest path: ONE fused plan execution for the whole dataset.

    MSTs come from the vectorized Borůvka `minimum_spanning_forest`; the
    field is the block-diagonal identity (N, n_max), made on `device` (None:
    the card), so one `integrate` returns every graph's dense kernel; M
    comes to the host once and each graph's spectrum is read off its block.
    `stats`, a dict, receives the plan's cross-bucket count (one B1 launch
    each an `integrate` on "cuda"), its engine, its `PlanSpec` (the same
    object when the content-hash cache served the plan), the forest, the
    kernels M on the host and the seconds of each stage."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    forest = Forest(minimum_spanning_forest(graphs))
    t1 = time.perf_counter()
    integ = Integrator.from_forest(forest, backend, device=dev)
    t2 = time.perf_counter()
    sizes, off = forest.tree_sizes, forest.offsets
    N, nmax = forest.num_vertices, int(sizes.max())
    rows = torch.arange(N, device=dev)
    starts = torch.repeat_interleave(torch.as_tensor(off[:-1], device=dev),
                                     torch.as_tensor(sizes, device=dev))
    E = torch.zeros((N, nmax), dtype=torch.float32, device=dev)
    E[rows, rows - starts] = 1.0
    fn = Exponential(LAM)
    M = integ.integrate(fn, E).cpu().numpy()  # (N, nmax)
    del E
    t3 = time.perf_counter()
    feats = np.array([_kernel_spectrum(M[off[t]:off[t] + s, :s], k)
                      for t, s in enumerate(sizes)])
    t4 = time.perf_counter()
    if stats is not None:
        stats.update(
            cross_buckets=len(integ.spec.cross_tgt_d0),
            engine=integ.describe(fn)["cross_engine"], spec=integ.spec,
            forest=forest, M=M, vertices=N, n_max=nmax,
            stage_s={"spanning_forest": t1 - t0, "plan": t2 - t1,
                     "integrate": t3 - t2, "spectra": t4 - t3})
    return feats


def features_bgfi(graphs, k=8):
    """Exact graph kernel (all-pairs Dijkstra): the accuracy reference."""
    return np.array([_kernel_spectrum(np.exp(LAM * graph_all_pairs(g)), k)
                     for g in graphs])


def _logreg(Xtr, ytr, Xte, classes=3, steps=400, lr=0.5):
    """Multinomial logistic regression in numpy."""
    mu, sd = Xtr.mean(0), Xtr.std(0) + 1e-9
    Xtr = (Xtr - mu) / sd
    Xte = (Xte - mu) / sd
    W = np.zeros((Xtr.shape[1] + 1, classes))
    Xb = np.c_[Xtr, np.ones(len(Xtr))]
    Y = np.eye(classes)[ytr]
    for _ in range(steps):
        logits = Xb @ W
        p = np.exp(logits - logits.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        W -= lr * Xb.T @ (p - Y) / len(Xb)
    return np.argmax(np.c_[Xte, np.ones(len(Xte))] @ W, axis=1)


def cross_val_accuracy(feats, labels, folds=5, seed=0):
    """Mean and std of the accuracy over `folds` interleaved folds of one
    seeded permutation."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    accs = []
    for f in range(folds):
        te = idx[f::folds]
        tr = np.setdiff1d(idx, te)
        pred = _logreg(feats[tr], labels[tr], feats[te])
        accs.append(np.mean(pred == labels[te]))
    return float(np.mean(accs)), float(np.std(accs))


def _rel_err(got, ref) -> float:
    return float(np.max(np.abs(got - ref))
                 / max(np.max(np.abs(ref)), 1e-12))


def _spectra_f64(M, forest, k=8):
    """Each tree's block of the packed kernels M read as the host loop reads
    its kernel: float64 `eigvalsh`. Against the host loop this measures the
    integration's error alone, without the float32 eigensolver's."""
    off = forest.offsets
    return np.array([
        np.linalg.eigvalsh(M[off[t]:off[t] + s, :s].astype(np.float64))[:k]
        for t, s in enumerate(forest.tree_sizes)])


def _size_range(text: str) -> tuple:
    lo, hi = (int(s) for s in text.split("-"))
    if not 2 <= lo < hi:
        raise argparse.ArgumentTypeError(
            f"size range must be lo-hi with 2 <= lo < hi, got {text!r}")
    return lo, hi


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, raising "
                         "without one; 'cpu' runs on the CPU)")
    ap.add_argument("--backend", default="torch",
                    help="comma list of the forest path's backends: torch "
                         "(the reference's 'plan'), cuda (its 'pallas')")
    ap.add_argument("--n-per-class", type=int, default=20)
    ap.add_argument("--size-range", type=_size_range, default=(24, 60),
                    help="graph sizes lo-hi, hi excluded (D&D: 30-540)")
    args = ap.parse_args(argv)
    backends = [b for b in args.backend.split(",") if b]
    bad = sorted(set(backends) - set(BACKENDS))
    if bad or not backends:
        ap.error(f"--backend takes a comma list of {BACKENDS}, got "
                 f"{args.backend!r}")
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    graphs, labels = make_dataset(args.n_per_class, args.size_range)
    t_data = time.perf_counter() - t0
    print(f"dataset: {len(graphs)} graphs of {args.size_range[0]}-"
          f"{args.size_range[1] - 1} vertices, 3 procedural families "
          f"(TUDataset stand-in, DESIGN §7), made in {t_data:.2f}s")
    t0 = time.perf_counter()
    fl = features_ftfi(graphs)  # the per-graph host loop baseline
    tl = time.perf_counter() - t0
    acc_l, std_l = cross_val_accuracy(fl, labels)
    result: dict = {"graphs": len(graphs), "dataset_s": t_data,
                    "size_range": list(args.size_range), "backends": {},
                    "features": {"host_loop": fl}}

    for backend in backends:
        cold, steady = {}, {}
        t0 = time.perf_counter()
        features_forest(graphs, backend=backend, device=dev, stats=cold)
        t_cold = time.perf_counter() - t0  # plan build included
        del cold["M"]
        t0 = time.perf_counter()
        fa = features_forest(graphs, backend=backend, device=dev,
                             stats=steady)  # the plan from the cache
        ta = time.perf_counter() - t0
        acc_a, std_a = cross_val_accuracy(fa, labels)
        err = _rel_err(fa, fl)
        f64 = _spectra_f64(steady["M"], steady["forest"])
        err64 = _rel_err(f64, fl)
        result.update(vertices=steady["vertices"], n_max=steady["n_max"])
        result["features"][backend] = fa
        result["features"][f"{backend}_f64"] = f64
        rec = result["backends"][backend] = {
            "cross_buckets": steady["cross_buckets"],
            "engine": steady["engine"], "integrate_calls": 2,
            "plan_reused": steady["spec"] is cold["spec"],
            "cold_ms": t_cold * 1e3, "steady_ms": ta * 1e3,
            "cold_stage_s": cold["stage_s"],
            "steady_stage_s": steady["stage_s"],
            "acc": acc_a, "acc_std": std_a, "rel_err": err,
            "rel_err_f64": err64,
            "speedup_vs_host_loop": tl / max(ta, 1e-12)}
        del steady
        print(f"FTFI forest-packed features [{backend}]: acc={acc_a:.3f}±"
              f"{std_a:.3f} (feature time {ta*1e3:.1f}ms steady / "
              f"{t_cold:.2f}s cold, one fused dispatch, "
              f"{rec['cross_buckets']} cross buckets, engine "
              f"{rec['engine']}, "
              f"{tl/max(ta,1e-12):.2f}x the host loop); "
              f"rel err vs host loop {err:.1e} (float32 spectra), "
              f"{err64:.1e} (float64 spectra)")

    print(f"FTFI per-graph host loop:    acc={acc_l:.3f}±{std_l:.3f} "
          f"(feature time {tl*1e3:.1f}ms)")
    t0 = time.perf_counter()
    fb = features_bgfi(graphs)
    tb = time.perf_counter() - t0
    acc_b, std_b = cross_val_accuracy(fb, labels)
    result["features"]["bgfi"] = fb
    print(f"BGFI exact graph kernel:     acc={acc_b:.3f}±{std_b:.3f} "
          f"(feature time {tb:.2f}s)")
    result["host_loop"] = {"acc": acc_l, "acc_std": std_l, "ms": tl * 1e3}
    result["bgfi"] = {"acc": acc_b, "acc_std": std_b, "ms": tb * 1e3}
    ta = result["backends"][backends[0]]["steady_ms"] / 1e3
    print(f"forest [{backends[0]}] vs per-graph loop: {tl/max(ta,1e-12):.2f}x; "
          f"feature-processing time reduction vs BGFI: {(tb-ta)/tb*100:.1f}%")
    return result


if __name__ == "__main__":
    main()
