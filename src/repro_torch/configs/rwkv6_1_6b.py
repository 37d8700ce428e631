"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay [arXiv:2404.05892].

24L d_model=2048 (attn-free) d_ff=7168 vocab=65536. num_heads fields are
unused by the rwkv mixer (heads = d_model / rwkv_head_dim = 32).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6_1_6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    layer_pattern="rwkv",
    rwkv_head_dim=64,
)

SMOKE_CONFIG = ArchConfig(
    name="rwkv6_1_6b_smoke",
    family="ssm",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    layer_pattern="rwkv",
    rwkv_head_dim=32,
    dtype="float32",
)
