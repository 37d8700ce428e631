"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=1536 24H (GQA kv=24 = MHA) d_ff=6144 vocab=2048. The EnCodec
frontend is a STUB per the assignment: input_specs() feeds precomputed
frame embeddings (B, S, d_model); the head predicts codebook tokens.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen_medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    mlp_variant="gelu",  # standard transformer FFN (matches the 1.5B total)
    frontend="audio_stub",
)

SMOKE_CONFIG = ArchConfig(
    name="musicgen_medium_smoke",
    family="audio",
    num_layers=4,
    d_model=96,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=256,
    frontend="audio_stub",
    dtype="float32",
)
