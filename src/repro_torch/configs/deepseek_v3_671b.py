"""deepseek-v3-671b [moe]: 61L d_model=7168 128H, MLA (kv_lora=512,
q_lora=1536), MoE 256 routed top-8 + 1 shared, expert d_ff=2048,
vocab=129280, MTP. [arXiv:2412.19437] First 3 layers dense (d_ff=18432)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128, num_kv_heads=128, head_dim=128,
    d_ff=18432,  # dense first layers
    vocab_size=129280,
    moe=True,
    num_experts=256,
    num_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    capacity_factor=1.0,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=3, first_dense_layers=1, d_model=64, num_heads=4,
    num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, num_experts=8,
    top_k=2, moe_d_ff=32, num_shared_experts=1, kv_lora_rank=32,
    q_lora_rank=48, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    mtp_depth=1)
