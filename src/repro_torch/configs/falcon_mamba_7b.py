"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attn-free) vocab=65024, state=16.
[arXiv:2410.05355] Mamba-1 architecture, built as the reference builds it
(no RMS norms on B, C and dt; see ROADMAP Queue C)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=1, num_kv_heads=1, head_dim=1,  # unused (attention-free)
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    dt_rank=256,
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, dt_rank=8, vocab_size=512, ssm_state=4)
