"""TopoViT-B/16 (the paper's own architecture, Sec 4.4 / Table 5): 12L,
d_model=768, 12H, d_ff=3072 (GeGLU), 196 patches (224/16), Performer
attention (phi = relu) with the topological mask f = exp(poly) of degree 2
over the MST of the patch grid: 3 learnable scalars per layer (synced)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="topovit-b16",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072,
    vocab_size=1000,  # classes (vit head)
    attention_variant="topo",
    performer_phi="relu",
    topo_g="exp",
    topo_degree=2,
    topo_synced=True,
    topo_dist_scale=1.0 / 16.0,
    num_prefix_embeddings=196,
    mlp_act="gelu",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, num_prefix_embeddings=16)
