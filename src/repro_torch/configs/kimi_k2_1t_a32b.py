"""Kimi-K2 1T-A32B — trillion-parameter MoE (paper-table config)
[arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert) vocab=163840,
MoE 384e top-8. head_dim pinned to 112 (d_model/64).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi_k2_1t_a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    moe_num_experts=384,
    moe_top_k=8,
)

SMOKE_CONFIG = ArchConfig(
    name="kimi_k2_smoke",
    family="moe",
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    moe_num_experts=8,
    moe_top_k=2,
    dtype="float32",
)
