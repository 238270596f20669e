"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H, MLA kv_lora=512,
MoE 64 routed top-6 + 2 shared, expert d_ff=1408, vocab=102400.
[arXiv:2405.04434] Layer 0 is dense (d_ff=10944)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=10944,  # dense first layer
    vocab_size=102400,
    moe=True,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, num_experts=8, top_k=2, moe_d_ff=32,
    num_shared_experts=1, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16)
