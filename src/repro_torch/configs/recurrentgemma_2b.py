"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, attn).
[arXiv:2402.19427] 26 = 8 superblocks x (rec,rec,attn) + tail (rec,rec)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    superblock=("rec", "rec", "attn"),
    num_superblocks=8,
    tail_blocks=("rec", "rec"),
    lru_width=2560,
    local_window=2048,
    mlp_act="gelu",
    tie_embeddings=True,
    emb_scale=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=5, num_superblocks=1, tail_blocks=("rec",), d_model=64,
    num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
    lru_width=64, local_window=8)
