"""The port's host-side plan builder against the reference's: graph
generators, MSTs and all-pairs distances agree exactly, and `build` gives
the same PlanSpec — every array field bitwise equal, the same digest — on a
random tree, a grid MST, an icosphere MST and a 55-graph mixed forest. Also:
the port imports and runs with jax and `repro` absent, and no file of it
(nor chip_smoke.py) imports either."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import ftfi as R  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro.graphs import meshes as RM  # noqa: E402
from repro.graphs import mst as RMST  # noqa: E402
from repro.graphs import traverse as RT  # noqa: E402
from repro_torch import ftfi as T  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402
from repro_torch.graphs import meshes as TM  # noqa: E402
from repro_torch.graphs import mst as TMST  # noqa: E402
from repro_torch.graphs import traverse as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _mixed_forest(G, num=55, seed=0, lo=8, hi=60):
    """tests/test_forest.py's mixed forest, from package G's generators."""
    rng = np.random.default_rng(seed)
    trees = [G.random_tree(int(s), seed=seed + i)
             for i, s in enumerate(rng.integers(lo, hi, size=num - 3))]
    trees += [G.path_graph(34), G.star_tree(27, seed=seed + 1),
              G.caterpillar_tree(41, seed=seed + 2)]
    return G.Forest(trees)


def _case(name):
    """(reference object, port object, leaf_size) for one topology."""
    if name == "random_tree":
        return RG.random_tree(400, seed=3), TG.random_tree(400, seed=3), 16
    if name == "grid_mst":
        return (RMST.minimum_spanning_tree(RG.grid_graph(14, 17)),
                TMST.minimum_spanning_tree(TG.grid_graph(14, 17)), 8)
    if name == "icosphere2_mst":
        return (RMST.minimum_spanning_tree(RM.mesh_graph(*RM.icosphere(2))),
                TMST.minimum_spanning_tree(TM.mesh_graph(*TM.icosphere(2))),
                16)
    if name == "synthetic_mst":
        return (RMST.minimum_spanning_tree(RG.synthetic_graph(500, 250, 1)),
                TMST.minimum_spanning_tree(TG.synthetic_graph(500, 250, 1)),
                32)
    assert name == "mixed_forest55"
    return _mixed_forest(RG), _mixed_forest(TG), 8


def _assert_same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert a.tobytes() == b.tobytes(), what
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    else:
        assert type(a) is type(b) and a == b, what


@pytest.mark.parametrize("name", ["random_tree", "grid_mst", "icosphere2_mst",
                                  "synthetic_mst", "mixed_forest55"])
def test_build_matches_reference_bitwise(name):
    ref_obj, port_obj, leaf = _case(name)
    rs, rp = R.build(ref_obj, leaf_size=leaf)
    ts, tp = T.build(port_obj, leaf_size=leaf, device="cpu")
    assert [f.name for f in dataclasses.fields(ts)] == [
        f.name for f in dataclasses.fields(rs)]
    for f in dataclasses.fields(rs):
        _assert_same(getattr(rs, f.name), getattr(ts, f.name), f.name)
    assert ts.digest == rs.digest
    # birth params: the same float64 -> float32 rounding as the reference
    for field in ("cross_tgt_d", "cross_src_d", "leaf_dists"):
        for a, b in zip(getattr(rp, field), getattr(tp, field)):
            assert np.asarray(a).tobytes() == b.numpy().tobytes(), field
    assert tp.tree_w is None


@pytest.mark.parametrize("kind", ["ring_lattice", "pref_attach", "community"])
def test_graph_generators_and_spanning_forest_match(kind):
    rg = [RG.random_graph_family(kind, 24 + 7 * i, seed=i) for i in range(4)]
    tg = [TG.random_graph_family(kind, 24 + 7 * i, seed=i) for i in range(4)]
    for a, b in zip(rg, tg):
        for f in ("edges_u", "edges_v", "weights"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    for a, b in zip(RMST.minimum_spanning_forest(rg),
                    TMST.minimum_spanning_forest(tg)):
        for f in ("edges_u", "edges_v", "weights"):
            assert np.array_equal(getattr(a, f), getattr(b, f))


def test_tree_distances_match():
    rt, tt = RG.random_tree(150, seed=9), TG.random_tree(150, seed=9)
    assert np.array_equal(RT.tree_all_pairs(rt), TT.tree_all_pairs(tt))
    us, vs = np.arange(150), np.arange(150)[::-1]
    assert np.array_equal(RT.TreeLCA(rt).distance(us, vs),
                          TT.TreeLCA(tt).distance(us, vs))
    verts_r, faces_r = RM.icosphere(1)
    verts_t, faces_t = TM.icosphere(1)
    assert np.array_equal(verts_r, verts_t)
    assert np.array_equal(faces_r, faces_t)


def test_reweightable_build_is_not_ported_yet():
    """Reweightable builds are ported now (the name is the refusal's it
    replaced): the port's reweightable spec is the reference's, every
    array field bitwise equal, on a tree and on the 55-graph forest."""
    for name in ("random_tree", "mixed_forest55"):
        robj, tobj, leaf = _case(name)
        rspec, _ = R.build(robj, leaf_size=leaf, reweightable=True)
        tspec, _ = T.build(tobj, leaf_size=leaf, reweightable=True,
                           device="cpu")
        assert tspec.reweightable and tspec.grid_h is None
        assert tspec.path_rows is not None and tspec.edges_u is not None
        assert tspec.digest == rspec.digest, name


_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
from repro_torch import ftfi
from repro_torch.core import cordial as C
from repro_torch.graphs.graph import random_tree
tree = random_tree(90, seed=1)
spec, params = ftfi.build(tree, leaf_size=8, device="cpu")
X = np.random.default_rng(0).normal(size=(90, 2))
Y = ftfi.apply(spec, params, C.Exponential(-0.5), X, backend="torch",
               device="cpu")
assert Y.shape == (90, 2) and bool(Y.isfinite().all())
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items()
               if v is not None)
print(len(mods))
"""


def test_port_imports_and_runs_without_jax_or_reference():
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) >= 15  # every module was imported


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_files_import_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 16
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f)
                                            & {"jax", "jaxlib", "repro"})
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}
