"""InternVL2-1B — VLM; backbone = InternLM2-ish decoder [arXiv:2404.16821].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The InternViT
frontend is a STUB per the assignment: input_specs() feeds precomputed
patch embeddings (B, S, d_model).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2_1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    frontend="vlm_stub",
)

SMOKE_CONFIG = ArchConfig(
    name="internvl2_1b_smoke",
    family="vlm",
    num_layers=4,
    d_model=112,
    num_heads=2,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    frontend="vlm_stub",
    dtype="float32",
)
