"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling. [hf:llava-hf] Vision tower is a stub:
input_specs provides (B, P, 1024) patch embeddings (P=1152, 2 anyres tiles);
the backbone prepends a 2-layer mm_projector (DESIGN §5)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision",
    num_prefix_embeddings=1152,
    rope_theta=5000000.0,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, num_prefix_embeddings=16)
