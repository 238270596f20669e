"""Roofline analysis of a per-device cost record (H100 SXM targets): the
reference's `roofline/analysis.py`.

Terms (seconds), from the per-device record of `roofline.count`:
  compute    = flops / PEAK_FLOPS               (989 TFLOP/s bf16 / GPU)
  memory     = bytes_accessed / HBM_BW          (3.35 TB/s / GPU)
  collective = collective operand bytes / ICI_BW  (NVLink 4, 450 GB/s
               per direction / GPU; the reference's name kept)

The reference parses its collective bytes from XLA's compiled HLO text,
which the port does not have: `collective_breakdown(census)` and
`collective_bytes(census)` read the record of a
`launch.sharding.CollectiveCensus` instead (the bytes each rank sends, the
operand: an all-gather its operand, a reduce-scatter operand = result x
group, as the reference reconstructs them), kinds named as the HLO
collectives are. `count_params` and `model_flops` read the port's
parameter names on the meta device (no memory): `blocks.{i}.…` unstacked,
where the reference reads its stacked leaves; the classes are the
reference's substrings on the '.'-joined names.
"""
from __future__ import annotations

from repro_torch.roofline.kernels import BF16_FLOPS_PER_S, HBM_BYTES_PER_S

# NVIDIA H100 SXM data sheet: bf16 dense on the tensor cores, 989.4 TFLOP/s
PEAK_FLOPS = BF16_FLOPS_PER_S
# NVIDIA H100 SXM data sheet: HBM3, 3.35 TB/s
HBM_BW = HBM_BYTES_PER_S
# NVIDIA H100 SXM data sheet: NVLink 4, 900 GB/s per GPU both ways, so
# 450e9 B/s per direction (the reference's name for its interconnect)
ICI_BW = 450e9


def _kind(name: str) -> str:
    """The census's kind as XLA names the collective (all_gather ->
    all-gather)."""
    return name.replace("_", "-")


def _census_record(census) -> tuple[dict, dict]:
    """(counts, bytes) by kind of a CollectiveCensus or of a dict with its
    `counts` and `bytes`."""
    if isinstance(census, dict):
        return census.get("counts", {}), census.get("bytes", {})
    return census.counts, census.bytes


def collective_breakdown(census) -> dict:
    """{"bytes": {kind: operand bytes}, "counts": {kind: n}} of one rank's
    collectives, from a `CollectiveCensus` (or its record). A cost
    count's record adds the calls of `launch.collectives`' helpers beside
    them (`roofline.count`)."""
    counts, nbytes = _census_record(census)
    return {"bytes": {_kind(k): float(v) for k, v in sorted(nbytes.items())},
            "counts": {_kind(k): int(v) for k, v in sorted(counts.items())}}


def collective_bytes(census) -> float:
    """Sum of operand bytes over every collective this rank issued."""
    return float(sum(_census_record(census)[1].values()))


def _named_sizes(cfg):
    from repro_torch.launch.specs import params_shapes

    return [(name, p.numel()) for name, p in
            params_shapes(cfg).named_parameters()]


def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts straight from the config."""
    flat = _named_sizes(cfg)
    total = sum(n for _, n in flat)
    inactive = 0
    for name, n in flat:
        if "experts_w" in name:
            frac_active = cfg.top_k / max(cfg.num_experts, 1)
            inactive += int(n * (1.0 - frac_active))
    return total, total - inactive


def model_flops(cfg, shape: dict) -> float:
    """Ideal matmul flops: 6·N·tokens (train) / 2·N·tokens (inference),
    charging each parameter group for the tokens that actually flow through
    it: embedding lookups are free; the LM head runs per *logit* position
    (all tokens in training, one per sequence at prefill/decode); encoder
    params see src frames and only when the encoder runs."""
    B, L, kind = shape["global_batch"], shape["seq_len"], shape["kind"]
    mult = 6.0 if kind == "train" else 2.0
    enc = head = embed = body = 0
    frac_active = cfg.top_k / max(cfg.num_experts, 1) if cfg.moe else 1.0
    for name, n in _named_sizes(cfg):
        if "blocks_enc" in name or "frontend_proj" in name:
            enc += n
        elif "lm_head" in name:
            head += n
        elif name.startswith("embed"):
            embed += n
        elif "experts_w" in name:
            body += int(n * frac_active)
        else:
            body += n
    if cfg.tie_embeddings:
        head = embed  # tied: the unembed matmul reuses the table
    tokens = B * (L if kind != "decode" else 1)
    logit_pos = B * L if kind == "train" else B
    total = mult * body * tokens + mult * head * logit_pos
    if cfg.is_encdec and kind != "decode":
        total += mult * enc * B * cfg.max_source_len
    return float(total)


def roofline_terms(rec: dict, cfg, shape: dict, n_chips: int) -> dict:
    compute_s = rec["flops"] / PEAK_FLOPS
    memory_s = rec["bytes_accessed"] / HBM_BW
    collective_s = rec["collective_bytes"] / ICI_BW
    dominant = max(
        [("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)], key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape)
    hlo_total = rec["flops"] * n_chips
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": (mf / hlo_total) if hlo_total else 0.0,
        "roofline_bound_s": max(compute_s, memory_s, collective_s),
    }
