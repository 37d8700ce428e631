"""Granite-34B-Code — deep dense code LM, MQA (kv=1) [arXiv:2405.04324].

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite_34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_variant="gelu",  # GPT-style 2-matrix MLP (matches the 34B total)
)

SMOKE_CONFIG = ArchConfig(
    name="granite_34b_smoke",
    family="dense",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    d_ff=512,
    vocab_size=512,
    dtype="float32",
)
