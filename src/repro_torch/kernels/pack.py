"""Bit-packed categorical code layout, the counterpart of
``repro.kernels.pack``.

Codes produced by the GEEK pipeline are narrow (t_cat discretization
bins in 4-5 bits, 16-bit truncated DOPH codes), so ``32 // bits`` codes
share one uint32 word. Distance becomes XOR + field-collapse + popcount
over ``d * bits / 32`` words, with mismatch counts identical to the
equality path (every b-bit field either matches exactly or differs).
Unused fields of the last word are zero on points and centers alike, so
they never mismatch.

Words are int32 tensors holding each uint32 word's bits
(``utils.hashing.u32_as_i32``), on every device: the layout the CUDA
kernel reads as ``uint32_t``. The plain arithmetic widens them to the
int64 carrier, masked with ``M32``. Also here: the one-hot encoding of
the matmul Hamming path.
"""
from __future__ import annotations

import torch

from repro_torch.utils.hashing import M32, u32_as_i32

SUPPORTED_BITS = (1, 2, 4, 8, 16, 32)

# uint32 with the lowest bit of every b-bit field set, per supported width
FIELD_LSB = {
    1: 0xFFFFFFFF,
    2: 0x55555555,
    4: 0x11111111,
    8: 0x01010101,
    16: 0x00010001,
    32: 0x00000001,
}


def bits_for_cardinality(card: int) -> int:
    """Smallest supported field width holding codes in [0, card)."""
    if card < 1:
        raise ValueError(f"cardinality must be positive, got {card}")
    for b in SUPPORTED_BITS:
        if b == 32 or (1 << b) >= card:
            return b
    return 32


def codes_per_word(bits: int) -> int:
    """Codes of width ``bits`` per uint32 word."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    return 32 // bits


def packed_width(d: int, bits: int) -> int:
    """Number of uint32 words per row for d codes of the given width."""
    cpw = codes_per_word(bits)
    return -(-d // cpw)


def _shifts(cpw: int, bits: int, device) -> torch.Tensor:
    return (torch.arange(cpw, dtype=torch.int32, device=device)
            * bits)[None, None, :]


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(n, d) int codes -> (n, packed_width(d, bits)) int32 words holding
    the uint32 words' bits. Codes are masked to ``bits``; unused fields
    are zero."""
    n, d = codes.shape
    cpw = codes_per_word(bits)
    if bits == 32:
        return u32_as_i32(codes.to(torch.int64))      # one code a word
    w = packed_width(d, bits)
    c = (codes & ((1 << bits) - 1)).to(torch.int32)
    c = torch.nn.functional.pad(c, (0, w * cpw - d)).reshape(n, w, cpw)
    # fields are disjoint, so the sum of shifted fields is their OR; torch
    # shifts int32 as uint32, so a top field in bit 31 makes the word's
    # negative int32, and no partial sum leaves the int32 range
    return torch.sum(c << _shifts(cpw, bits, codes.device), dim=-1,
                     dtype=torch.int32)


def unpack_codes(packed: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """Inverse of pack_codes: (n, w) words -> (n, d) int32."""
    n, w = packed.shape
    cpw = codes_per_word(bits)
    fields = ((packed.to(torch.int64)[:, :, None] >> _shifts(cpw, bits,
                                                             packed.device))
              & ((1 << bits) - 1))
    return fields.reshape(n, w * cpw)[:, :d].to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of uint32 values (carried, or int32 bits) -> int32.

    The int64 product ``x * 0x01010101`` carries past bit 31, so it is
    masked to 32 bits before the ``>> 24``, as uint32 arithmetic wraps.
    """
    x = x.to(torch.int64) & M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & M32) >> 24).to(torch.int32)


def field_mismatch_count(xor_words: torch.Tensor, bits: int) -> torch.Tensor:
    """#mismatching b-bit fields per word of ``x ^ c``: OR-fold each field
    onto its lowest bit (log2(bits) shift/or steps), mask to one bit per
    field, popcount."""
    z = xor_words.to(torch.int64) & M32
    s = bits >> 1
    while s:
        z = z | (z >> s)
        s >>= 1
    return popcount32(z & FIELD_LSB[bits])


def field_mismatch_swar(xor_words: torch.Tensor, bits: int) -> torch.Tensor:
    """``field_mismatch_count`` as the CUDA kernel computes it: the SWAR
    field test ``(((z & low) + low) | z) & high``, ``high`` each field's
    top bit and ``low = ~high``, then a popcount (bits 1: ``popc(z)``;
    32: ``z != 0``). ``(z & low) + low`` stays below 2**bits in every
    field, so no carry crosses a field, and the top bit of a field is set
    iff that field of ``z`` is not zero. The plain paths keep the OR-fold;
    this one holds the kernel's arithmetic to it in the tests."""
    z = xor_words.to(torch.int64) & M32
    if bits == 1:
        return popcount32(z)
    if bits == 32:
        return (z != 0).to(torch.int32)
    high = (FIELD_LSB[bits] << (bits - 1)) & M32
    low = ~high & M32
    return popcount32((((z & low) + low) | z) & high)


#: the packed Hamming kernel's edge cases: every field of every 64-word
#: row mismatching (the count's largest per-word sums), fields differing
#: only in their top or their lowest bit (the edges of the field test), a
#: dead tile of 32 centers between live ones with k not a multiple of 32
#: (the skip of a tile with no valid center)
PACKED_CASES = ("every field mismatching", "top bit only", "lowest bit only",
                "dead tile between live ones")


def packed_case(case: str, bits: int, n: int, gen: torch.Generator,
                device=None):
    """(codes (n, d), centers (k, d) int64 field values, valid (k,) bool)
    of one of ``PACKED_CASES`` at field width ``bits``, drawn from
    ``gen`` on ``device`` (its device by default). Shared by the card
    tests, ``chip_smoke.py`` and ``tools/kernel_variants.py``."""
    device = gen.device if device is None else device
    hi = 2**32 if bits == 32 else 1 << bits

    def randint(lo, high, shape):
        return torch.randint(lo, high, shape, generator=gen, device=device)
    if case == "dead tile between live ones":
        k, d = 100, 45
        cen, codes = randint(0, hi, (k, d)), randint(0, hi, (n, d))
        codes[::3] = cen[40]                    # the dead tile's center
        codes[1::3] = cen[70]
        i = torch.arange(k, device=device)
        return codes, cen, (i < 20) | (i >= 64)
    k, d = 70, 64 * 32 // bits                  # 64 words a row
    valid = torch.arange(k, device=device) % 7 != 3
    if case == "every field mismatching":       # rows' top bits set, not
        return (randint(hi // 2, hi, (n, d)),    # the centers'
                randint(0, hi // 2, (k, d)), valid)
    if case not in PACKED_CASES:
        raise ValueError(f"unknown packed case {case!r}")
    cen = randint(0, hi, (k, d))
    flip = 1 << (bits - 1) if case == "top bit only" else 1
    mask = torch.rand((n, d), generator=gen, device=device) < 0.2
    return cen[randint(0, k, (n,))] ^ (mask * flip), cen, valid


def packed_hamming(xp: torch.Tensor, cp: torch.Tensor, bits: int
                   ) -> torch.Tensor:
    """(n, w) x (k, w) packed codes -> (n, k) int32 mismatch counts."""
    z = xp[:, None, :] ^ cp[None, :, :]
    return torch.sum(field_mismatch_count(z, bits), dim=-1, dtype=torch.int32)


def onehot_codes(codes: torch.Tensor, card: int,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """(n, d) codes in [0, card) -> (n, d*card) one-hot rows.

    Codes outside [0, card) give an all-zero block, as ``jax.nn.one_hot``
    does.
    """
    n, d = codes.shape
    c = codes.to(torch.int64)
    oh = c[:, :, None] == torch.arange(card, device=codes.device)
    return oh.to(dtype).reshape(n, d * card)
