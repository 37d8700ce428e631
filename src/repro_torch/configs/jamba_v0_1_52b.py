"""Jamba-v0.1-52B — hybrid Mamba+attention (1:7) with MoE [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Attention every 8th layer; MoE ffn every 2nd layer (period = 8).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe_num_experts=16,
    moe_top_k=2,
    moe_every=2,
    layer_pattern="jamba",
    attn_every=8,
    mamba_d_state=16,
    mamba_expand=2,
)

SMOKE_CONFIG = ArchConfig(
    name="jamba_v0_1_52b_smoke",
    family="hybrid",
    num_layers=8,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    moe_num_experts=4,
    moe_top_k=2,
    moe_every=2,
    layer_pattern="jamba",
    attn_every=8,
    mamba_d_state=8,
    mamba_expand=2,
    dtype="float32",
)
