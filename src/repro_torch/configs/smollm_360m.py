"""SmolLM-360M — llama-arch small dense LM [hf:HuggingFaceTB/SmolLM family].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm_360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
)

SMOKE_CONFIG = ArchConfig(
    name="smollm_360m_smoke",
    family="dense",
    num_layers=4,
    d_model=96,
    num_heads=3,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    dtype="float32",
)
