"""Qwen1.5-0.5B — dense LM with QKV bias [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1_5_0_5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
)

SMOKE_CONFIG = ArchConfig(
    name="qwen1_5_0_5b_smoke",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=384,
    vocab_size=512,
    qkv_bias=True,
    dtype="float32",
)
