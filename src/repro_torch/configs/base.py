"""Model configuration schema + registry (--arch lookup), over all the
reference's archs.

`ModelConfig` has the reference's fields, defaults and `replace`, so a
reference config maps onto the port's field by field.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    attention_variant: str = "full"  # full | performer | topo
    # who executes full attention and causal linear attention:
    #   naive   - full: the reference's dense `_sdpa` (materialized scores,
    #             the oracle); performer / topo "fft": the plain chunked twin
    #   chunked - full: the plain online-softmax twin of `_sdpa_chunked`;
    #             performer / topo "fft": the plain chunked twin
    #   cuda    - full: the flash attention CUDA kernel; performer / topo
    #             "fft": the linear attention CUDA kernel (on CPU tensors
    #             each kernel's wrapper runs its plain version)
    # and, in the ssm family, who runs the selective scan:
    #   naive   - the sequential oracle (kernels/selective_scan/ref.py)
    #   chunked - the plain chunked scan (an associative scan per chunk)
    #   cuda    - the selective scan CUDA kernel (plain on CPU tensors)
    # any other value raises
    attn_impl: str = "naive"
    performer_phi: str = "relu"  # relu | sq | quart | exp
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0

    # topological (paper) masking
    topo_g: str = "exp"
    topo_degree: int = 1  # t: #poly coeffs - 1; (t+1)+1(scale)=3 params synced
    topo_synced: bool = True
    topo_dist_scale: float = 1.0 / 256.0
    # sequence-mask attention impl: ref (dense O(L^2) oracle) | torch (the
    # plain chunked sweep, the reference's XLA twin) | cuda (the fused
    # kernel, the reference's "pallas") | fft (the separable decay path at
    # g=exp, degree <= 1, through causal linear attention and attn_impl;
    # other masks Alg. 1 with the Toeplitz-FFT FastMult, FFTs in float64)
    topo_attn_impl: str = "fft"
    # plan backend of the ViT's grid-mask fastmult, "torch" | "cuda" (None:
    # follow topo_attn_impl — cuda -> cuda, else torch)
    topo_backend: Optional[str] = None
    # the multi-rank plan executor (core.plan_shard) for the ViT's mask
    # fastmults over the active launch.sharding mesh; without one, or with
    # one rank on its plan axis, the single-device executor
    topo_shard_plan: bool = False

    # mlp
    mlp_act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)

    # MoE
    moe: bool = False
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0
    router_aux_loss: float = 0.001
    moe_groups: int = 1  # data-local dispatch groups (§Perf iteration B)

    # MLA (deepseek)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0

    # hybrid (recurrentgemma)
    superblock: tuple = ()  # e.g. ("rec", "rec", "attn")
    num_superblocks: int = 0
    tail_blocks: tuple = ()
    lru_width: int = 0
    local_window: int = 0

    # encoder-decoder
    is_encdec: bool = False
    encoder_layers: int = 0
    decoder_layers: int = 0
    max_source_len: int = 3072  # encoder memory length (audio frames)

    # multimodal stub frontend
    frontend: Optional[str] = None  # audio | vision
    num_prefix_embeddings: int = 0  # patch/frame embeddings fed directly

    # norm / misc
    norm_eps: float = 1e-6
    remat_policy: str = "dots"  # dots | nothing (full remat) | none (no remat)
    seq_sharded_residuals: bool = False  # Megatron-SP residual stream
    tie_embeddings: bool = False
    emb_scale: bool = False  # gemma scales embeddings by sqrt(d)
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # MTP (deepseek-v3 multi-token prediction) — extra head depth
    mtp_depth: int = 0

    def padded_vocab(self, multiple: int = 256) -> int:
        v = self.vocab_size
        return ((v + multiple - 1) // multiple) * multiple

    @property
    def d_inner(self) -> int:  # mamba
        return self.ssm_expand * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------------

ARCHS = ["falcon_mamba_7b", "seamless_m4t_medium", "recurrentgemma_2b",
         "llava_next_34b", "granite_34b", "qwen2_1_5b", "llama3_2_1b",
         "gemma_7b", "deepseek_v2_lite_16b", "deepseek_v3_671b",
         "topovit_b16"]

_ALIASES = {"falcon-mamba-7b": "falcon_mamba_7b",
            "seamless-m4t-medium": "seamless_m4t_medium",
            "recurrentgemma-2b": "recurrentgemma_2b",
            "llava-next-34b": "llava_next_34b",
            "granite-34b": "granite_34b", "qwen2-1.5b": "qwen2_1_5b",
            "llama3.2-1b": "llama3_2_1b", "gemma-7b": "gemma_7b",
            "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
            "deepseek-v3-671b": "deepseek_v3_671b",
            "topovit-b16": "topovit_b16"}


def _module(arch: str):
    mod_name = _ALIASES.get(arch, arch)
    if mod_name not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}: expected one of {ARCHS} "
                         f"or an alias {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).CONFIG
    return cfg.replace(**overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).SMOKE_CONFIG
    return cfg.replace(**overrides) if overrides else cfg


# input shapes assigned to the LM family (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
