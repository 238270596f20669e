"""The port's `flat_stats` and example entry points against the reference.

`repro_torch.core.flat_stats` returns the reference's dict on every tree of
tests/test_itree_flat.py's list (each package's `build_flat_it` on the same
tree) and agrees with the port's `it_stats` of the materialized IT. Each
example of `repro_torch.examples` runs on the CPU at small sizes
(`--device cpu`) and meets the reference script's own claims: the
quickstart's relative errors against BTFI at most 1e-5 and a finite,
non-zero edge-weight gradient; the mesh interpolation's best cosine within
1e-6 of the reference's computation on the same meshes and seed, at the
same lambda; every served request answered in full; finite training losses for
both variants. Without a card each example raises unless given
`--device cpu`."""
import contextlib
import importlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import Integrator as RIntegrator  # noqa: E402
from repro.core import Rational as RRational  # noqa: E402
from repro.core.itree_flat import build_flat_it as ref_build  # noqa: E402
from repro.core.itree_flat import flat_stats as ref_stats  # noqa: E402
from repro.graphs.meshes import icosphere as ref_icosphere  # noqa: E402
from repro.graphs.meshes import mesh_graph as ref_mesh_graph  # noqa: E402
from repro.graphs.meshes import vertex_normals as ref_normals  # noqa: E402
from repro.graphs.mst import minimum_spanning_tree as ref_mst  # noqa: E402
from repro_torch.core import (build_flat_it, build_integrator_tree,  # noqa: E402
                              flat_stats, it_stats)
from repro_torch.graphs.graph import WeightedTree  # noqa: E402
from test_itree_flat import TREES  # noqa: E402

EXAMPLES = ("quickstart", "mesh_interpolation", "serve_lm",
            "train_topological_lm", "graph_classification")
REL_TOL = 1e-5  # examples/quickstart.py's claim: exact against BTFI
COS_TOL = 1e-6


def _main(name, argv):
    """The example's main on argv, its printed lines kept quiet."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with contextlib.redirect_stdout(io.StringIO()):
        return mod.main(argv)


@pytest.mark.parametrize("name,mk", TREES, ids=[t[0] for t in TREES])
def test_flat_stats_matches_reference(name, mk):
    ref_tree = mk()
    tree = WeightedTree(ref_tree.num_vertices, ref_tree.edges_u,
                        ref_tree.edges_v, ref_tree.weights)
    for leaf in (16, 64):
        want = ref_stats(ref_build(ref_tree, leaf_size=leaf,
                                   use_cache=False))
        got = flat_stats(build_flat_it(tree, leaf_size=leaf,
                                       use_cache=False))
        assert got == want
        assert all(type(got[k]) is type(want[k]) for k in want)
        st = it_stats(build_integrator_tree(tree, leaf_size=leaf))
        assert (st["internal"], st["leaves"], st["balance_ok"]) == (
            got["internal"], got["leaves"], got["balance_ok"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_or_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(name, [])


def test_quickstart_is_exact():
    res = _main("quickstart", ["--n", "1200", "--device", "cpu"])
    errs = [res["host_rel_err"], res["fastmult_rel_err"]] + [
        b["rel_err"] for b in res["backends"].values()]
    assert max(errs) <= REL_TOL, res
    assert res["backends"]["cuda"]["engine"] == "fdist_matvec:exp"
    assert res["backends"]["cuda"]["cross_buckets"] > 0
    assert res["edge_grad_shape"] == (199,)
    assert res["edge_grad_finite"] and res["edge_grad_l1"] > 0


def test_mesh_interpolation_matches_reference():
    got = _main("mesh_interpolation", ["--device", "cpu"])
    # the reference script's computation: one rng through both meshes
    rng = np.random.default_rng(0)
    for subdiv in (3, 4):
        verts, faces = ref_icosphere(subdiv)
        n = verts.shape[0]
        normals = ref_normals(verts, faces)
        integ = RIntegrator(ref_mst(ref_mesh_graph(verts, faces)),
                            backend="host", leaf_size=256)
        known = rng.random(n) < 0.2
        F = np.where(known[:, None], normals, 0.0)
        best = (-1.0, None)
        for lam in (1.0, 4.0, 16.0):
            pred = integ.integrate(RRational((1.0,), (1.0, 0.0, lam)), F)
            pred /= np.maximum(np.linalg.norm(pred, axis=1, keepdims=True),
                               1e-12)
            cos = float(np.mean(np.sum(pred[~known] * normals[~known],
                                       axis=1)))
            if cos > best[0]:
                best = (cos, lam)
        assert got[subdiv]["n"] == n
        assert abs(got[subdiv]["cosine"] - best[0]) <= COS_TOL
        assert got[subdiv]["lambda"] == best[1]


def test_serve_lm_answers_every_request():
    res = _main("serve_lm", ["--device", "cpu"])
    assert res["requests"] == 10 and res["tokens"] == 120
    assert all(e is None for e in res["errors"])
    assert all(len(o) == 12 and all(0 <= t < res["vocab_size"] for t in o)
               for o in res["outs"])


def test_train_topological_lm_trains_both_variants(tmp_path):
    res = _main("train_topological_lm", [
        "--steps", "3", "--batch", "2", "--seq", "32", "--topo-impl", "cuda",
        "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    for variant in ("performer", "topo"):
        losses = np.asarray(res["losses"][variant])
        assert losses.shape == (3,) and np.all(np.isfinite(losses))
        assert (tmp_path / f"topolm_{variant}").is_dir()
    assert np.isfinite(res["delta"])
