"""Sec 4.3's learnable rational f on the port (`core/fit.py`) against the
reference's `repro.core.fit`: the same sampled training pairs bit for bit,
30 AdamW steps of `fit_rational_f` (each loss within 1e-5 relative, the
final params within 1e-4 of their max, the relative Frobenius error within
1e-5), and the graph traversals the fit reads (`dijkstra`,
`graph_all_pairs`, `tree_distances_from`, `tree_pair_distances`) equal to
the reference's."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import fit as RF  # noqa: E402
from repro.graphs import graph as RG  # noqa: E402
from repro.graphs import mst as RMST  # noqa: E402
from repro.graphs import traverse as RT  # noqa: E402
from repro_torch.core import fit as TF  # noqa: E402
from repro_torch.graphs import graph as TG  # noqa: E402
from repro_torch.graphs import mst as TMST  # noqa: E402
from repro_torch.graphs import traverse as TT  # noqa: E402


def _pair(n, extra):
    rg, tg = RG.synthetic_graph(n, extra, seed=1), TG.synthetic_graph(
        n, extra, seed=1)
    return rg, RMST.minimum_spanning_tree(rg), tg, \
        TMST.minimum_spanning_tree(tg)


def test_traversals_match_reference():
    rg, rt, tg, tt = _pair(60, 30)
    for s in (0, 17, 59):
        assert np.array_equal(TT.dijkstra(tg, s), RT.dijkstra(rg, s))
        assert np.array_equal(TT.tree_distances_from(tt, s),
                              RT.tree_distances_from(rt, s))
    assert np.array_equal(TT.graph_all_pairs(tg), RT.graph_all_pairs(rg))
    us, vs = np.arange(60), (np.arange(60) * 7) % 60
    assert np.array_equal(TT.tree_pair_distances(tt, us, vs),
                          RT.tree_pair_distances(rt, us, vs))


def test_sample_training_pairs_equal():
    rg, rt, tg, tt = _pair(60, 30)
    for seed in (0, 3):
        want = RF.sample_training_pairs(rg, rt, 100, seed)
        got = TF.sample_training_pairs(tg, tt, 100, seed)
        for a, b in zip(got, want):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("n,extra", [(60, 30), (400, 200)])
def test_fit_rational_f_matches_reference(n, extra):
    rg, rt, tg, tt = _pair(n, extra)
    want = RF.fit_rational_f(rg, rt, num_deg=2, den_deg=2, num_pairs=100,
                             steps=30, seed=0, eval_frobenius=True)
    got = TF.fit_rational_f(tg, tt, num_deg=2, den_deg=2, num_pairs=100,
                            steps=30, seed=0, eval_frobenius=True,
                            device="cpu")
    assert got.losses.shape == want.losses.shape == (30,)
    assert np.all(np.abs(got.losses - want.losses)
                  <= 1e-5 * np.abs(want.losses))
    for k in ("num", "den"):
        scale = np.abs(want.params[k]).max()
        assert np.abs(got.params[k] - want.params[k]).max() <= 1e-4 * scale
    assert abs(got.rel_frobenius - want.rel_frobenius) <= \
        1e-5 * want.rel_frobenius
    assert TF.tree_metric_frobenius_error(tg, tt) == \
        RF.tree_metric_frobenius_error(rg, rt)
    # the losses fall, as the reference's do
    assert got.losses[-1] < got.losses[0]
