"""Architecture configuration of the LM substrate (the counterpart of
``repro.models.config``, kept as a copy: the port imports nothing of
``repro``).

One frozen dataclass drives model construction. Exact dimension sets live
in ``repro_torch/configs/<id>.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

MixKind = Literal["attn", "mamba", "rwkv"]
FfnKind = Literal["mlp", "moe", "rwkv_ffn"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # -- MLP --
    mlp_variant: str = "swiglu"      # swiglu | gelu
    d_ff_dense: int = 0              # dense-layer d_ff in MoE archs (0 -> d_ff)
    # -- MoE --
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1               # MoE ffn every N layers (jamba: 2)
    moe_shared_experts: int = 0      # always-on experts alongside routed ones
    moe_capacity_factor: float = 1.25
    moe_weight_dtype: str = ""       # "" -> param dtype; "float8_e4m3fn"
                                     # halves FSDP weight-gather wire bytes
    # -- hybrid / SSM --
    layer_pattern: str = "attn"      # attn | mamba | rwkv | jamba
    attn_every: int = 8              # hybrid: one attn layer per this many
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_dt_rank: int = 0           # 0 -> ceil(d_model / 16)
    mamba_conv: int = 4
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    # -- modality frontend (stub: input_specs feeds embeddings directly) --
    frontend: str | None = None      # None | vlm_stub | audio_stub
    # -- runtime --
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (MXU lane alignment and
        tp-divisibility — Megatron-style padding; labels stay < vocab_size).
        Only internvl2 (151655 -> 151680) is affected among the assigned set."""
        return -(-self.vocab_size // 128) * 128

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """True when serve memory/compute per token is o(S^2) end-to-end —
        SSM / hybrid archs. Pure full-attention archs skip long_500k."""
        return self.layer_pattern in ("mamba", "rwkv", "jamba")

    def layer_plan(self) -> list[tuple[str, str]]:
        """(mix_kind, ffn_kind) per layer."""
        plan = []
        for i in range(self.num_layers):
            if self.layer_pattern == "attn":
                mix = "attn"
            elif self.layer_pattern == "mamba":
                mix = "mamba"
            elif self.layer_pattern == "rwkv":
                mix = "rwkv"
            elif self.layer_pattern == "jamba":
                # 1:7 attn:mamba interleave — one attn per attn_every block
                mix = "attn" if i % self.attn_every == self.attn_every // 2 else "mamba"
            else:
                raise ValueError(self.layer_pattern)
            if mix == "rwkv":
                ffn = "rwkv_ffn"
            elif self.moe_num_experts > 0 and (i % self.moe_every == self.moe_every - 1):
                ffn = "moe"
            else:
                ffn = "mlp"
            plan.append((mix, ffn))
        return plan

    def period(self) -> int:
        """Smallest repeating block of the layer plan (scan unit)."""
        plan = self.layer_plan()
        for p in range(1, len(plan) + 1):
            if len(plan) % p == 0 and plan == plan[:p] * (len(plan) // p):
                return p
        return len(plan)
