"""Llama-4-Maverick 400B-A17B — MoE top-1, early fusion
[hf:meta-llama/Llama-4 family].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4_maverick_400b_a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe_num_experts=128,
    moe_top_k=1,
    moe_every=2,           # hf: interleave_moe_layer_step = 2
    moe_shared_experts=1,  # always-on shared expert in MoE layers
    d_ff_dense=16384,      # hf: intermediate_size_mlp for dense layers
)

SMOKE_CONFIG = ArchConfig(
    name="llama4_maverick_smoke",
    family="moe",
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    moe_num_experts=4,
    moe_top_k=1,
    dtype="float32",
)
