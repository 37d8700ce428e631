"""Qwen3-0.6B — dense LM with qk-norm + GQA [hf:Qwen/Qwen3 family].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_0_6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
)

SMOKE_CONFIG = ArchConfig(
    name="qwen3_0_6b_smoke",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    qk_norm=True,
    dtype="float32",
)
