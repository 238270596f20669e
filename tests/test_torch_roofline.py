"""The port's roofline (`repro_torch.roofline`) against the reference's
`repro.roofline.analysis`: `count_params` and `model_flops` of every
dry-run arch at train_4k and decode_32k (the port reads its parameters on
the meta device, the reference its `jax.eval_shape` leaves; computed once
per (arch, shape) pair), `roofline_terms`' arithmetic with the H100
constants and a decode cell's terms against the reference's, `collective_breakdown` of hand-built and counted censuses, and
the kernels' work formulas (`roofline/kernels.py`, which `chip_smoke.py`
imports) at the shapes of PERF.md's bound column."""
from __future__ import annotations

import functools

import pytest

from repro.configs import base as RB
from repro.roofline import analysis as RA
from repro_torch.configs import base as TB
from repro_torch.launch.dryrun import DRY_ARCHS
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import kernels as RK

PAIRS = [(a, s) for a in DRY_ARCHS for s in ("train_4k", "decode_32k")]


@functools.lru_cache(maxsize=None)
def _reference(arch, shape):
    """The reference's (count_params, model_flops), once per pair."""
    cfg = RB.get_config(arch)
    return RA.count_params(cfg), RA.model_flops(cfg, RB.SHAPES[shape])


def test_dry_archs_are_the_references():
    assert DRY_ARCHS == [a for a in RB.ARCHS if a != "topovit_b16"]
    assert TB.SHAPES == RB.SHAPES


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_count_params_and_model_flops_match_reference(arch, shape):
    want_params, want_flops = _reference(arch, shape)
    cfg = TB.get_config(arch)
    assert TA.count_params(cfg) == want_params
    assert TA.model_flops(cfg, TB.SHAPES[shape]) == want_flops


def test_llama_model_flops_split():
    """Llama-3.2-1B: 973,146,112 body parameters and a tied 262,668,288
    head (PERF.md's prediction of 5l reads these)."""
    cfg = TB.get_config("llama3_2_1b")
    total, active = TA.count_params(cfg)
    assert total == active == 973_146_112 + 262_668_288
    shape = dict(seq_len=4096, global_batch=4, kind="prefill")
    assert TA.model_flops(cfg, shape) == (2.0 * 973_146_112 * 4 * 4096
                                          + 2.0 * 262_668_288 * 4)


def test_roofline_terms_arithmetic():
    """The reference's case (tests/test_roofline.py), H100 constants."""
    assert (TA.PEAK_FLOPS, TA.HBM_BW, TA.ICI_BW) == (989e12, 3.35e12, 450e9)
    cfg = TB.get_config("llama3_2_1b")
    rec = {"flops": TA.PEAK_FLOPS, "bytes_accessed": TA.HBM_BW,
           "collective_bytes": TA.ICI_BW * 2}
    out = TA.roofline_terms(rec, cfg, TB.SHAPES["train_4k"], 256)
    assert abs(out["compute_s"] - 1.0) < 1e-9
    assert abs(out["memory_s"] - 1.0) < 1e-9
    assert abs(out["collective_s"] - 2.0) < 1e-9
    assert out["dominant"] == "collective"
    assert out["roofline_bound_s"] == 2.0
    assert 0 < out["useful_flops_ratio"] < 10
    # the same arithmetic as the reference's, term for term
    ref = RA.roofline_terms({"flops": 1e15, "bytes_accessed": 2e12,
                             "collective_bytes": 3e10},
                            RB.get_config("llama3_2_1b"),
                            RB.SHAPES["train_4k"], 256)
    got = TA.roofline_terms({"flops": 1e15, "bytes_accessed": 2e12,
                             "collective_bytes": 3e10}, cfg,
                            TB.SHAPES["train_4k"], 256)
    assert got["model_flops"] == ref["model_flops"]
    assert got["compute_s"] == 1e15 / 989e12
    assert got["compute_s"] / ref["compute_s"] == pytest.approx(
        197e12 / 989e12, rel=1e-12)
    assert got["dominant"] == ref["dominant"] == "compute"


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_decode_roofline_terms_match_reference(shape):
    """A decode cell's terms, one token a row: Llama-3.2-1B's model flops
    are 2 x (body + tied head) x B, and `roofline_terms` of one record
    equal the reference's term for term (its TPU constants scaled to the
    H100's)."""
    cfg = TB.get_config("llama3_2_1b")
    B = TB.SHAPES[shape]["global_batch"]
    assert TA.model_flops(cfg, TB.SHAPES[shape]) == (
        2.0 * 973_146_112 * B + 2.0 * 262_668_288 * B)
    rec = {"flops": 3.6e10, "bytes_accessed": 1.2e11,
           "collective_bytes": 4.9e6}
    got = TA.roofline_terms(rec, cfg, TB.SHAPES[shape], 256)
    ref = RA.roofline_terms(rec, RB.get_config("llama3_2_1b"),
                            RB.SHAPES[shape], 256)
    assert got["model_flops"] == ref["model_flops"]
    assert got["useful_flops_ratio"] == ref["useful_flops_ratio"]
    for term, const in (("compute_s", "PEAK_FLOPS"), ("memory_s", "HBM_BW"),
                        ("collective_s", "ICI_BW")):
        assert got[term] * getattr(TA, const) == pytest.approx(
            ref[term] * getattr(RA, const), rel=1e-12), term
    assert got["dominant"] == "memory"


def test_collective_breakdown_of_a_hand_built_census():
    """Operand bytes as the reference reconstructs them: an all-gather
    counts its operand, a reduce-scatter its operand = result x group."""
    census = {"counts": {"all_gather": 2, "reduce_scatter": 1,
                         "all_to_all": 1},
              "bytes": {"all_gather": 2 * 4 * 128 * 4,
                        "reduce_scatter": 8 * 128 * 4 * 8,
                        "all_to_all": 32 * 32 * 2}}
    b = TA.collective_breakdown(census)
    assert b == {"bytes": {"all-gather": 4096.0, "all-to-all": 2048.0,
                           "reduce-scatter": 32768.0},
                 "counts": {"all-gather": 2, "all-to-all": 1,
                            "reduce-scatter": 1}}
    assert TA.collective_bytes(census) == 4096 + 32768 + 2048


def test_collective_breakdown_of_a_counted_census():
    """A CollectiveCensus over a fake group of 8 ranks records the bytes
    each rank sends: the all-gather's (4, 128) f32 operand, the
    reduce-scatter's (64, 128) operand (its (8, 128) result x 8)."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.sharding import CollectiveCensus

    with fake_group(8), CollectiveCensus() as cen:
        x = torch.ones(4, 128)
        out = torch.empty(32, 128)
        dist.all_gather_into_tensor(out, x)
        big = torch.ones(64, 128)
        dist.reduce_scatter_tensor(torch.empty(8, 128), big)
        dist.all_to_all_single(torch.empty(32, 32, dtype=torch.bfloat16),
                               torch.ones(32, 32, dtype=torch.bfloat16))
    assert not dist.is_initialized()
    b = TA.collective_breakdown(cen)
    assert b["counts"] == {"all-gather": 1, "all-to-all": 1,
                           "reduce-scatter": 1}
    assert b["bytes"] == {"all-gather": 4 * 128 * 4.0,
                          "all-to-all": 32 * 32 * 2.0,
                          "reduce-scatter": 8 * 128 * 4 * 8.0}


def test_kernel_work_formulas_at_perf_shapes():
    """The bound column of PERF.md §6 from the formulas chip_smoke.py
    imports: B5 causal bf16 at (4, 32, 8, 4096, 64) 0.278 ms, B4 0.141
    ms (bytes); a windowed B5's pairs are the loop's."""
    ms, by = RK.bound(*RK.flash_work(4, 32, 8, 4096, 64, True, 2),
                      RK.BF16_FLOPS_PER_S)
    assert (round(ms, 3), by) == (0.278, "operations")
    ms, by = RK.bound(*RK.linear_work(4, 32, 4096, 64, 64, 2),
                      RK.TF32_FLOPS_PER_S / 3)
    assert (round(ms, 3), by) == (0.141, "bytes")
    for L, W in ((4096, 2048), (1537, 2048), (3001, 1), (7, 7)):
        loop = sum(min(i + 1, W) for i in range(L))
        _, ops = RK.flash_work(1, 1, 1, L, 16, True, 4, window=W)
        assert ops == loop * 2 * 32
