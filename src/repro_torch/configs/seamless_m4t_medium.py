"""seamless-m4t-medium [audio]: 12L enc + 12L dec, d_model=1024, 16H (MHA),
d_ff=4096, vocab=256206. [arXiv:2308.11596] Audio frontend is a stub:
input_specs provides precomputed (B, S, 1024) frame embeddings; the encoder
memory length is max_source_len=3072 frames (architectural max), while the
assigned seq_len applies to the decoder stack (DESIGN §5)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    is_encdec=True,
    num_layers=24,
    encoder_layers=12,
    decoder_layers=12,
    d_model=1024,
    num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    max_source_len=3072,
    frontend="audio",
)

SMOKE_CONFIG = CONFIG.replace(
    encoder_layers=2, decoder_layers=2, num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    max_source_len=24)
