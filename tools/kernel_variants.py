#!/usr/bin/env python3
"""What holds a hand-written kernel back: variants of its source, timed.

    python tools/kernel_variants.py [--kernel flash|l2|acc|packed|all]
        [--against DIR]

Each variant is the committed source (``src/repro_torch/kernels/csrc``)
with one string edit, compiled by ``nvcc`` with the build's own flags
into a temporary directory (all at once), loaded with ``ctypes`` into the
port's wrapper in place of the built library, and timed on the card by
``torch.profiler`` (device time alone, no host time) at the main path's
inputs:

- ``flash``: ``flash_attention`` at Qwen3-0.6B's prefill, (1, 16, 8,
  2,048, 64) bf16 causal, in the LM's (B, S, H, dh) layout seen
  transposed. Variants: P as 2 or 1 bf16 parts instead of 3 (fewer
  ``mma`` for P·V; each is also held to the plain version at the bf16
  tolerance over a few seeds and shapes, printed as the worst error over
  its limit), no P·V ``mma``, no Q·Kᵀ ``mma``, no softmax (P = S), only
  the loads, barriers and epilogue, and the library ``expf`` in place of
  ``ex2``. SDPA's kernel is timed beside them.
- ``l2``: ``distance_argmin_l2`` at (1,000,000, 1,024, 128) float32 with
  the first 158 centers valid (a fitted model's layout) and with all
  valid. Variants: the chunk's dot loop fully unrolled, 32-dim chunks,
  and 256-thread blocks with 8 × 4 or 4 × 8 register tiles. ``x @ c.T``
  is timed beside them.
- ``acc``: ``distance_argmin_l2_accumulate`` at (1,000,000, 1,024, 128)
  float32 with the first 106 and 158 centers valid (the table-sync fit's
  layout), and ``distance_argmin_l2`` beside it; each variant prints the
  blocks an SM holds. Variants: one column a thread instead of four, 4 or
  16 groups' slot values loaded at once instead of 8, the tile routine
  inlined, rows read from device memory instead of shared memory; and,
  to split the time of the sums, without the slot loads and stores,
  without the row adds, without either, and without the sort too. With ``--against DIR`` (another
  checkout, e.g. an earlier commit unpacked), its source and its wrapper
  run beside the committed one, in the order other, committed, committed,
  other, and every output of the two is held equal bit for bit.
- ``packed``: ``distance_argmin_hamming_packed`` at the sparse main
  path's shape, (2,396,130, 1,024, 32 words) of random fields with the
  first 62 centers valid, at 16- and 4-bit fields. Variants of the
  committed count, (a) the SWAR field test and a ``__popc`` a word
  (``csrc/distance_argmin_hamming.cu`` ``Packed::term``): (b) each
  field's flag shifted to its lowest bit and added into per-field lanes,
  flushed into the count before a lane can overflow, no ``__popc``; (c)
  up to BITS words' flags shifted onto disjoint bits, one ``__popc`` for
  them; the reference's OR-fold in place of the field test; no
  ``__popc`` at all; two rows a thread, each center load serving both;
  (e*) the field test's add, and the count's adds or not, as IMAD on the
  FMA pipe (their multiplier, blockDim.x / 256 = 1, hidden from the
  compiler), with 0, 1 or 2 pairs of every 4 words on one ``__popc`` (the
  odd word's flags moved down a bit by an IMAD.HI): the op mixes behind
  ``chip_smoke.py``'s ``PACKED_OPS``; 16-center tiles, at most 85
  registers a thread (3 blocks an SM), and 32-word rows in two 16-word
  chunks.
  Each variant is held bit for bit against the plain version at every
  field width (``pack.PACKED_CASES``: every field mismatching in 64-word
  rows, top-bit-only and lowest-bit-only differences, a dead tile) and
  against the committed kernel at the timed shape, and
  prints the opcode counts of its 16-bit kernel's SASS. With ``--against
  DIR`` the packed and the equality kernel (same source; at the
  heterogeneous path's (2,000,000, 1,024, 9), all valid) of the other
  checkout run beside the committed ones (other, committed, committed,
  other), held bit for bit.

Variants that drop work are for timing only: they break the function.
Needs the card and ``nvcc``; the variants' libraries go to a temporary
directory that is removed at exit.
"""
import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import distance_argmin as da  # noqa: E402
from repro_torch.kernels import distance_argmin_hamming as dh  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from chip_smoke import device_ms  # noqa: E402

MMA_PV = """            mma(o[2 * np], pa[part], vb[0], vb[1]);
            mma(o[2 * np + 1], pa[part], vb[2], vb[3]);
"""
MMA_QK = """        mma(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
"""
#: the softmax of a key tile, from its first comment to P V's (P = S)
SOFTMAX = ("    // scale and mask", "    // O += P V",
           "    const float corr[2] = {1.f, 1.f};\n\n")
L2_TILE = """constexpr int TM = 8;                   // rows per thread: ty + 16 i
constexpr int TN = 8;                   // centers per thread: tx + 8 j
constexpr int LANES = 8;                // threads that share a row
constexpr int THREADS = 128;"""
L2_UNROLL = "#pragma unroll 2\n      for (int dd = 0; dd < BD; dd += 4) {"


ACC_KERNELS = ("l2_argmin_acc_kernel", "sum_slots_kernel")
ACC_ADDS = """    if (quads)
      add_groups<float4>(src, rs, ps, d, ng, gkey, gstart, gend, srow);
    else
      add_groups<float>(src, rs, ps, d, ng, gkey, gstart, gend, srow);
"""
ACC_SORT = ("    const int lab = tile_lab[tid];",
            "    const float* src = from_smem ? xs : x + row0 * d;",
            "    const int ng = 0;\n")
#: appended to the accumulating variants: blocks an SM holds, through the
#: committed host code's own shared-memory sizing
ACC_OCCUPANCY = """
extern "C" int repro_acc_occupancy(int d, int k) {
  const auto kern = l2_argmin_acc_kernel<true>;
  size_t bytes;
  if (prepare(kern, true, d, k, &bytes, k) != cudaSuccess) return -1;
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS, bytes);
  return blocks;
}
"""


#: the packed kernel's count of a 4-word group, and hooks that let a
#: count carry state (per-field lanes, shifted masks) across a center's
#: words: ``Op::group`` adds a group, ``Op::flush`` empties the state
PK_TERMS = """          acc[i] += Op::term(xr[j], v.x) + Op::term(xr[j + 1], v.y) +
                    Op::term(xr[j + 2], v.z) + Op::term(xr[j + 3], v.w);"""
PK_GROUP = "          acc[i] += Op::group(lanes, j, xr, v);"
PK_CENTER = ("      for (int i = 0; i < BK; ++i) {\n#pragma unroll\n"
             "        for (int j = 0; j < DC; j += 4) {")
PK_CENTER_STATE = PK_CENTER.replace(
    "++i) {", "++i) {\n        uint32_t lanes = 0;")
PK_END = ("        }\n      }\n    }\n\n#pragma unroll\n"
          "    for (int i = 0; i < BK; ++i) {")
PK_END_FLUSH = PK_END.replace(
    "        }\n      }\n    }",
    "        }\n        acc[i] += Op::flush(lanes);\n      }\n    }", 1)
#: two rows a thread (tid and tid + 128 of the block's 256), each center
#: load serving both
PK_TWO_ROWS = [
    ("constexpr int THREADS = 256;  // rows per block, one per thread",
     "constexpr int THREADS = 128, ROWS = 256;"),
    ("e < THREADS * DC; e += THREADS", "e < ROWS * DC; e += THREADS"),
    ("xs[THREADS][DC + 1];", "xs[ROWS][DC + 1];"),
    ("(long long)blockIdx.x * THREADS;\n  const long long row = row0 + tid;",
     "(long long)blockIdx.x * ROWS;\n"
     "  const long long row = row0 + tid, row2 = row + THREADS;"),
    ("  int32_t xr[DC];\n  int best = big, best_i = 0;",
     "  int32_t xr[DC], xr2[DC];\n"
     "  int best = big, best_i = 0, best2 = big, best2_i = 0;"),
    ("for (int j = 0; j < DC; ++j) xr[j] = xs[tid][j];",
     "for (int j = 0; j < DC; ++j) {\n"
     "      xr[j] = xs[tid][j];\n      xr2[j] = xs[tid + THREADS][j];\n    }"),
    ("    int acc[BK];\n#pragma unroll\n"
     "    for (int i = 0; i < BK; ++i) acc[i] = 0;",
     "    int acc[BK], acc2[BK];\n#pragma unroll\n"
     "    for (int i = 0; i < BK; ++i) acc[i] = acc2[i] = 0;"),
    (PK_TERMS, PK_TERMS + "\n" + PK_TERMS.replace("acc[i]", "acc2[i]")
     .replace("xr[", "xr2[").replace("          Op", "           Op")),
    ("          best_i = k0 + i;\n        }",
     "          best_i = k0 + i;\n        }\n"
     "        const int dist2 = Op::finish(acc2[i], d);\n"
     "        if (dist2 < best2) {\n          best2 = dist2;\n"
     "          best2_i = k0 + i;\n        }"),
    ("    counts[row] = best;\n  }",
     "    counts[row] = best;\n  }\n  if (row2 < n) {\n"
     "    labels[row2] = best2_i;\n    counts[row2] = best2;\n  }"),
    ("(n + THREADS - 1) / THREADS", "(n + ROWS - 1) / ROWS"),
]
EQ_FINISH = "  __device__ __forceinline__ static int finish(int acc, int d) {"
EQ_HOOKS = """  template <int DC>
  __device__ __forceinline__ static int group(uint32_t&, int j,
                                              const int32_t (&x)[DC], int4 v) {
    return term(x[j], v.x) + term(x[j + 1], v.y) + term(x[j + 2], v.z) +
           term(x[j + 3], v.w);
  }
  __device__ __forceinline__ static int flush(uint32_t&) { return 0; }
""" + EQ_FINISH
PK_FINISH = ("  __device__ __forceinline__ static int finish(int acc, "
             "int /*d*/) {")


def pk_hooks(add, flush):
    """Packed's ``group`` and ``flush`` around ``add``, the C++ that takes
    the flags ``nonzero_fields(z)`` of word ``jj`` (BITS in 2..16)."""
    return f"""  template <int DC>
  __device__ __forceinline__ static int group(uint32_t& lanes, int j,
                                              const int32_t (&x)[DC], int4 v) {{
    const int32_t c4[4] = {{v.x, v.y, v.z, v.w}};
    int m = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {{
      const int jj = j + q;
      const uint32_t z = (uint32_t)x[jj] ^ (uint32_t)c4[q];
      if constexpr (BITS == 1) {{
        m += __popc(z);
      }} else if constexpr (BITS == 32) {{
        m += z != 0u;
      }} else {{
{add}
      }}
    }}
    return m;
  }}
  __device__ __forceinline__ static int flush(uint32_t& lanes) {{
{flush}
  }}
""" + PK_FINISH


#: (b): each field's flag moved to its lowest bit and added there; a lane
#: of BITS bits holds 2^BITS - 1 words, then the lanes are folded into m
PK_LANES = pk_hooks(
    """        lanes += nonzero_fields(z) >> (BITS - 1);
        if ((jj + 1) % ((1 << BITS) - 1) == 0) m += flush(lanes);""",
    """    uint32_t l = lanes;
    lanes = 0;
#pragma unroll
    for (int s = BITS; s < 32; s *= 2) {
      const uint32_t mask = 0xFFFFFFFFu / ((1ull << s) + 1);
      l = (l & mask) + ((l >> s) & mask);
    }
    return (int)l;""")
#: (c): BITS words' flags shifted onto disjoint bits, one popc for them
PK_SHIFTED = pk_hooks(
    """        lanes |= nonzero_fields(z) >> (jj % BITS);
        if ((jj + 1) % BITS == 0) m += flush(lanes);""",
    """    const int m = __popc(lanes);
    lanes = 0;
    return m;""")
PK_STATE = [(PK_CENTER, PK_CENTER_STATE), (PK_TERMS, PK_GROUP),
            (PK_END, PK_END_FLUSH), (EQ_FINISH, EQ_HOOKS)]
PK_ORFOLD = ("    return (((z & kLow) + kLow) | z) & kHigh;",
             "#pragma unroll\n    for (int s = BITS >> 1; s > 0; s >>= 1) "
             "z |= z >> s;\n    return z & (kHigh >> (BITS - 1));")
#: the kernel's count of a 4-word group through ``Op::group``, which takes
#: the center's running count and returns it
PK_ACC_GROUP = "          acc[i] = Op::group(acc[i], xr, j, v);"
EQ_GROUP = """  template <int DC>
  __device__ __forceinline__ static int group(int acc, const int32_t (&x)[DC],
                                              int j, int4 v) {
    return acc + (term(x[j], v.x) + term(x[j + 1], v.y) +
                  term(x[j + 2], v.z) + term(x[j + 3], v.w));
  }
""" + EQ_FINISH


def pk_pipes(pairs, imad_count):
    """Packed's ``group`` with the field test's add as an IMAD (the FMA
    pipe: its multiplier, blockDim.x / 256 = 1, is hidden from the
    compiler), ``pairs`` pairs of the 4 words on one ``__popc`` (the odd
    word's flags moved down a bit by an IMAD.HI), and the count's adds as
    IMAD or as plain adds."""
    count = "mad(__popc(w[q]), u, a)" if imad_count else "a + __popc(w[q])"
    return f"""  __device__ __forceinline__ static uint32_t mad(uint32_t a, uint32_t b,
                                                  uint32_t c) {{
    uint32_t r;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
  }}
  template <int DC>
  __device__ __forceinline__ static int group(int acc, const int32_t (&x)[DC],
                                              int j, int4 v) {{
    if constexpr (BITS == 1 || BITS == 32) {{
      return acc + (term(x[j], v.x) + term(x[j + 1], v.y) +
                    term(x[j + 2], v.z) + term(x[j + 3], v.w));
    }} else {{
      const int32_t c4[4] = {{v.x, v.y, v.z, v.w}};
      uint32_t u;
      asm("{{ .reg .u32 t; mov.u32 t, %%ntid.x; shr.u32 %0, t, 8; }}"
          : "=r"(u));
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {{
        const uint32_t z = (uint32_t)x[j + q] ^ (uint32_t)c4[q];
        w[q] = (mad(z & kLow, u, kLow) | z) & kHigh;
      }}
#pragma unroll
      for (int p = 0; p < {pairs}; ++p)
        w[2 * p] += __umulhi(w[2 * p + 1], u << 31);
      uint32_t a = (uint32_t)acc;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q % 2 == 0 || q / 2 >= {pairs}) a = {count};
      return (int)a;
    }}
  }}
""" + PK_FINISH


#: occupancy: at most 85 registers a thread, so that an SM holds 3 blocks
#: of 256 threads (2 at the committed 126); tiles of 16 centers (16 counts
#: a thread in registers, not 32); rows of 17-32 words in two 16-word
#: chunks (16 row words in registers, not 32)
PK_BLOCKS3 = ("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 3)")
PK_BK16 = ("constexpr int BK = 32;", "constexpr int BK = 16;")
PK_DC16 = ("  else if (cols <= 16)\n    hamming_argmin_kernel<Op, 16>",
           "  else if (cols <= 32)\n    hamming_argmin_kernel<Op, 16>")
#: the mangled name of the packed kernel at 16-bit fields, 32-word chunks
PK_KERNEL16 = "PackedILi16EEELi32E"
PK_OPCODES = ("LOP3", "IADD3", "VIADD", "IMAD", "IMAD.HI", "SHF", "LEA",
              "POPC", "ISETP", "LDS")


def edit(src, *change):
    """Replace ``old`` by ``new``, or, given (start, end, new), the text
    from ``start`` up to ``end``."""
    if len(change) == 3:
        start, end, new = change
        i, j = src.find(start), src.find(end)
        if i < 0 or j < i:
            raise RuntimeError(f"variant span not found: {start!r}")
        return src[:i] + new + src[j:]
    old, new = change
    if old not in src:
        raise RuntimeError(f"variant edit not found: {old[:60]!r}")
    return src.replace(old, new)


def l2_tile(tm, tn, lanes, threads):
    return (L2_TILE, f"constexpr int TM = {tm};\nconstexpr int TN = {tn};\n"
            f"constexpr int LANES = {lanes};\nconstexpr int THREADS = {threads};")


VARIANTS = {
    "flash": ("flash_attention", {
        "as committed (P in 3 parts, ex2)": [],
        "P in 2 parts": [("P_PARTS = 3", "P_PARTS = 2")],
        "P in 1 part": [("P_PARTS = 3", "P_PARTS = 1")],
        "no P.V mma (timing only)": [(MMA_PV, "")],
        "no Q.K mma (timing only)": [(MMA_QK, "")],
        "no softmax, P = S (timing only)": [SOFTMAX],
        "loads, barriers, epilogue only (timing only)": [
            (MMA_QK, ""), (MMA_PV, ""), SOFTMAX],
        "library expf": [("exp2_approx(m[i] - mn)",
                          "expf((m[i] - mn) * 0.6931472f)"),
                         ("exp2_approx(s[j][e] - m[e >> 1])",
                          "expf((s[j][e] - m[e >> 1]) * 0.6931472f)")],
    }),
    "l2": ("distance_argmin", {
        "as committed (8 x 8, 128 threads, 64-dim chunks, unroll 2)": [],
        "dot loop fully unrolled": [(L2_UNROLL, L2_UNROLL.replace(
            "unroll 2", "unroll"))],
        "32-dim chunks": [("constexpr int BD = 64;", "constexpr int BD = 32;")],
        "8 x 4 tile, 256 threads": [l2_tile(8, 4, 16, 256)],
        "4 x 8 tile, 256 threads": [l2_tile(4, 8, 8, 256)],
    }),
    "acc": ("distance_argmin", {
        "as committed (four columns a thread, 8 groups at once)": [],
        "one column a thread": [("    if (quads)\n", "    if (false)\n")],
        "4 groups at once": [("constexpr int GB = 8;",
                              "constexpr int GB = 4;")],
        "16 groups at once": [("constexpr int GB = 8;",
                               "constexpr int GB = 16;")],
        "slot values neither loaded nor stored (timing only)": [
            ("          acc[b] = reinterpret_cast<const T*>(ps + (size_t)gkey[gb] "
             "* d)[cv];", "          acc[b] = T();"),
            ("          reinterpret_cast<T*>(ps + (size_t)gkey[gb] * d)[cv] = "
             "acc[b];", "          reinterpret_cast<T*>(ps)[cv] = acc[b];")],
        "slot values loaded and stored, no row adds (timing only)": [
            ("            add_to(acc[b], reinterpret_cast<const T*>(src + "
             "srow[i] * rs)[cv]);", "            ;")],
        "tile routine inlined": [
            ("    l2_argmin_tile_call<RES>(smem, x, c, csq, valid, n, k, d, "
             "row0, labels,", "    l2_argmin_tile<RES>(smem, x, c, csq, "
             "valid, n, k, d, row0, labels,")],
        "rows read from device memory": [
            ("  const bool from_smem = RES && any_valid;",
             "  const bool from_smem = false;")],
        "no group adds (timing only)": [(ACC_ADDS, "")],
        "no sort, no adds (timing only)": [ACC_SORT, (ACC_ADDS, "")],
    }),
    "packed": ("distance_argmin_hamming", {
        "as committed ((a) field test, a popc a word; 1 row a thread)": [],
        "(b) per-field lanes, flushed, no popc": PK_STATE + [
            (PK_FINISH, PK_LANES)],
        "(c) BITS words' flags on disjoint bits, one popc": PK_STATE + [
            (PK_FINISH, PK_SHIFTED)],
        "the OR-fold in place of the field test": [PK_ORFOLD],
        "no popc, the flags summed (timing only)": [
            ("else return __popc(nonzero_fields(z));",
             "else return nonzero_fields(z);")],
        "2 rows a thread": PK_TWO_ROWS,
        **{f"(e{p}{'i' if i else ''}) t as IMAD, {p} pair(s) of 4 words on "
           f"one popc, count adds as {'IMAD' if i else 'adds'}": [
               (PK_TERMS, PK_ACC_GROUP), (EQ_FINISH, EQ_GROUP),
               (PK_FINISH, pk_pipes(p, i))]
           for p, i in ((0, False), (0, True), (1, False), (1, True),
                        (2, True))},
        "3 blocks an SM (85 registers)": [PK_BLOCKS3],
        "16-center tiles": [PK_BK16],
        "16-word chunks for 32-word rows": [PK_DC16],
        "16-center tiles, 3 blocks an SM": [PK_BK16, PK_BLOCKS3],
    }),
}


def compile_all(which, tmp):
    """Compile every variant of the chosen kernels at once; returns
    {(kernel, variant): library path} and prints each one's registers."""
    procs = {}
    for kernel in which:
        source, variants = VARIANTS[kernel]
        text = (build.CSRC / f"{source}.cu").read_text()
        for i, (name, edits) in enumerate(variants.items()):
            src = text
            for change in edits:
                src = edit(src, *change)
            if kernel == "acc":
                src += ACC_OCCUPANCY
            cu = os.path.join(tmp, f"{kernel}{i}.cu")
            with open(cu, "w") as f:
                f.write(src)
            lib = cu[:-3] + ".so"
            procs[(kernel, name)] = (lib, subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        entry = {"flash": "flash_attention_bf16_kernelILi64",
                 "l2": "l2_argmin_kernelILb1",
                 "acc": "l2_argmin_acc_kernelILb1",
                 "packed": PK_KERNEL16}[key[0]]
        lines = out.splitlines()
        regs = next((f"{lines[i + 3].split(':')[-1].strip()}; "
                     f"{lines[i + 2].strip()}"
                     for i, line in enumerate(lines[:-3]) if entry in line), "")
        print(f"  built {key[0]} '{key[1]}': {regs}", flush=True)
        if key[0] == "packed":
            print(f"    SASS of its 16-bit, 32-word kernel: "
                  f"{build.sass_counts(lib, PK_KERNEL16, PK_OPCODES)}", flush=True)
        libs[key] = lib
    return libs


def worst_ratio(cases):
    """Largest |kernel − plain| over the bf16 limit (1e-6 + 2^-7·|plain|)."""
    worst = 0.0
    for (q, k, v), want in cases:
        got = fa.flash_attention(q, k, v, causal=True).float()
        worst = max(worst, float(((got - want).abs()
                                  / (1e-6 + 2.0**-7 * want.abs())).max()))
    return worst


def run_flash(libs, dev):
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((1, 2048, 16, 64), generator=gen, device=dev)
    k, v = (torch.randn((1, 2048, 8, 64), generator=gen, device=dev)
            for _ in range(2))
    q, k, v = (t.bfloat16().transpose(1, 2) for t in (q, k, v))
    cases = []
    for seed in range(4):
        for B, Hq, Hkv, S, dh in ((2, 8, 2, 100, 64), (1, 2, 1, 70, 128),
                                  (1, 16, 8, 2048, 64)):
            g = torch.Generator(device=dev).manual_seed(1000 * seed + S)
            t = tuple(torch.randn((B, h, S, dh), generator=g, device=dev)
                      .bfloat16() for h in (Hq, Hkv, Hkv))
            cases.append((t, ref.attention_ref(*t, causal=True).float()))
    print("flash_attention at (1,16,8,2048,64) bf16 causal, device ms:")
    for (kernel, name), lib in libs.items():
        if kernel != "flash":
            continue
        fn = ctypes.CDLL(lib).repro_flash_attention
        fn.argtypes, fn.restype = fa._ARGTYPES, ctypes.c_int
        fa._entries["repro_flash_attention"] = fn
        ms = device_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20,
                       "flash_attention_bf16_kernel")
        print(f"  {name}: {ms:.4f} ms; worst error / bf16 limit "
              f"{worst_ratio(cases):.3f}", flush=True)
    fa._entries.clear()
    sdpa = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20, "sdpa")
    print(f"  SDPA's kernel: {sdpa:.4f} ms")


def run_l2(libs, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1_000_000, 128), generator=gen, device=dev)
    c = torch.randn((1024, 128), generator=gen, device=dev)
    print("distance_argmin_l2 at (1000000,1024,128), device ms with 158 / "
          "1024 valid:")
    entry = da._entry
    try:
        for (kernel, name), lib in libs.items():
            if kernel != "l2":
                continue
            fn = ctypes.CDLL(lib).repro_l2_argmin_f32
            fn.argtypes, fn.restype = da._ARGTYPES, ctypes.c_int
            da._entry = lambda fn=fn: fn
            ms = [device_ms(lambda: da.distance_argmin_l2(
                x, c, torch.arange(1024, device=dev) < kv), 10, "l2_argmin")
                for kv in (158, 1024)]
            print(f"  {name}: {ms[0]:.4f} / {ms[1]:.4f} ms", flush=True)
    finally:
        da._entry = entry
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"  x @ c.T (all 1024, float32): "
          f"{device_ms(lambda: x @ c.T, 10, ''):.4f} ms")


def other_accumulate(root, tmp):
    """``distance_argmin_l2_accumulate`` of the checkout at ``root``: its
    wrapper module, bound to a library compiled from its own source."""
    lib = os.path.join(tmp, "other_distance_argmin.so")
    src = os.path.join(root, "src", "repro_torch", "kernels", "csrc",
                       "distance_argmin.cu")
    out = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{out.stdout}"
                           f"{out.stderr}")
    spec = importlib.util.spec_from_file_location(
        "other_distance_argmin",
        os.path.join(root, "src", "repro_torch", "kernels",
                     "distance_argmin.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn = ctypes.CDLL(lib).repro_l2_argmin_acc_f32
    fn.argtypes, fn.restype = mod._ACC_ARGTYPES, ctypes.c_int
    mod._acc_entry = lambda: fn
    return mod.distance_argmin_l2_accumulate


def run_acc(libs, dev, against, tmp):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1_000_000, 128), generator=gen, device=dev)
    c = x[torch.randperm(1_000_000, generator=gen, device=dev)[:1024]]
    valid = {kv: torch.arange(1024, device=dev) < kv for kv in (106, 158)}
    print("distance_argmin_l2_accumulate at (1000000,1024,128), device ms "
          "with 106 / 158 valid (kernel and slot sums):")
    entry = da._acc_entry
    try:
        for (kernel, name), lib in libs.items():
            if kernel != "acc":
                continue
            so = ctypes.CDLL(lib)
            fn = so.repro_l2_argmin_acc_f32
            fn.argtypes, fn.restype = da._ACC_ARGTYPES, ctypes.c_int
            da._acc_entry = lambda fn=fn: fn
            ms = [device_ms(lambda v=v: da.distance_argmin_l2_accumulate(
                x, c, v), 10, ACC_KERNELS) for v in valid.values()]
            print(f"  {name}: {ms[0]:.4f} / {ms[1]:.4f} ms; "
                  f"{so.repro_acc_occupancy(128, 1024)} blocks an SM",
                  flush=True)
    finally:
        da._acc_entry = entry
    ms = [device_ms(lambda v=v: da.distance_argmin_l2(x, c, v), 10,
                    "l2_argmin") for v in valid.values()]
    print(f"  distance_argmin_l2 on the same inputs: {ms[0]:.4f} / "
          f"{ms[1]:.4f} ms")
    if against is None:
        return
    other = other_accumulate(against, tmp)
    ours = da.distance_argmin_l2_accumulate
    for kv, v in valid.items():
        a, b = other(x, c, v), ours(x, c, v)
        same = all(torch.equal(p, q) for p, q in zip(a, b))
        times = {}
        for who, fn in (("other", other), ("committed", ours),
                        ("committed", ours), ("other", other)):
            times.setdefault(who, []).append(device_ms(
                lambda fn=fn: fn(x, c, v), 10, ACC_KERNELS))
        print(f"  {kv} valid: {against} {times['other']} ms, committed "
              f"{times['committed']} ms (other, committed, committed, "
              f"other); labels, d², sums and counts bit-identical: {same}",
              flush=True)
        if not same:
            raise AssertionError("the two checkouts' outputs differ")


def bind_hamming(mod, lib):
    """Point the wrapper module ``mod`` at the library ``lib``."""
    so = ctypes.CDLL(lib)

    def entry(name, argtypes):
        fn = getattr(so, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn
    mod._entry = entry


def other_hamming(root, tmp):
    """The Hamming wrappers of the checkout at ``root``, bound to a library
    compiled from its own source."""
    lib = os.path.join(tmp, "other_distance_argmin_hamming.so")
    src = os.path.join(root, "src", "repro_torch", "kernels", "csrc",
                       "distance_argmin_hamming.cu")
    out = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{out.stdout}"
                           f"{out.stderr}")
    spec = importlib.util.spec_from_file_location(
        "other_distance_argmin_hamming",
        os.path.join(root, "src", "repro_torch", "kernels",
                     "distance_argmin_hamming.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bind_hamming(mod, lib)
    return mod


def packed_cases(dev):
    """(bits, d, words, centers, valid): every width's edge cases
    (``pack.PACKED_CASES``), packed, held to the plain version."""
    from repro_torch.kernels import pack
    gen = torch.Generator(device=dev).manual_seed(1)
    for bits in pack.SUPPORTED_BITS:
        for case in pack.PACKED_CASES:
            codes, cen, valid = pack.packed_case(case, bits, 300, gen)
            yield (bits, codes.shape[1], pack.pack_codes(codes, bits),
                   pack.pack_codes(cen, bits), valid)


def run_packed(libs, dev, against, tmp):
    n, k, w, kv = 2_396_130, 1024, 32, 62
    gen = torch.Generator(device=dev).manual_seed(0)
    xp = torch.randint(-2**31, 2**31, (n, w), generator=gen, device=dev,
                       dtype=torch.int32)
    cp = torch.randint(-2**31, 2**31, (k, w), generator=gen, device=dev,
                       dtype=torch.int32)
    valid = torch.arange(k, device=dev) < kv
    codes = torch.randint(0, 12, (2_000_000, 9), generator=gen, device=dev,
                          dtype=torch.int32)
    cen = torch.randint(0, 12, (k, 9), generator=gen, device=dev,
                        dtype=torch.int32)
    every = torch.ones(k, dtype=torch.bool, device=dev)
    small = list(packed_cases(dev))
    want_small = [ref.distance_argmin_hamming_packed_ref(x, c, v, bits=b, d=d)
                  for b, d, x, c, v in small]
    want = {b: dh.distance_argmin_hamming_packed(xp, cp, valid, bits=b)
            for b in (16, 4)}

    def packed(mod, b):
        return lambda: mod.distance_argmin_hamming_packed(xp, cp, valid,
                                                          bits=b)

    def timed(fn, match):
        """Device ms a call of ``fn`` after ~0.1 s of it (the card at its
        working clock)."""
        for _ in range(60):
            fn()
        return device_ms(fn, 10, match)

    def exact(mod):
        for (b, d, x, c, v), (lp, cp_) in zip(small, want_small):
            lk, ck = mod.distance_argmin_hamming_packed(x, c, v, bits=b, d=d)
            if not (torch.equal(lk, lp) and torch.equal(ck, cp_.int())):
                return False
        return all(torch.equal(p, q) for b in want
                   for p, q in zip(packed(mod, b)(), want[b]))

    print(f"distance_argmin_hamming_packed at ({n},{k},{w} words), first "
          f"{kv} valid, device ms at 16 / 4 bits:")
    entry = dh._entry
    try:
        for (kernel, name), lib in libs.items():
            if kernel != "packed":
                continue
            bind_hamming(dh, lib)
            ms16, ms4 = (timed(packed(dh, b), "Packed") for b in (16, 4))
            print(f"  {name}: {ms16:.4f} / {ms4:.4f} ms; bit-exact at every "
                  f"width: {exact(dh)}", flush=True)
    finally:
        dh._entry = entry
    if against is None:
        return
    other = other_hamming(against, tmp)
    for what, fns in (
            *((f"packed, {b} bits", [packed(m, b) for m in (other, dh)])
              for b in (16, 4)),
            ("equality at (2000000,1024,9), all valid", [
                lambda m=m: m.distance_argmin_hamming(codes, cen, every)
                for m in (other, dh)])):
        same = all(torch.equal(p, q) for p, q in zip(fns[0](), fns[1]()))
        times = {}
        for who, fn in (("other", fns[0]), ("committed", fns[1]),
                        ("committed", fns[1]), ("other", fns[0])):
            times.setdefault(who, []).append(
                f"{timed(fn, 'hamming_argmin_kernel'):.4f}")
        print(f"  {what}: {against} {', '.join(times['other'])} ms, "
              f"committed {', '.join(times['committed'])} ms (other, "
              f"committed, committed, other); labels and counts "
              f"bit-identical: {same}", flush=True)
        if not same:
            raise AssertionError("the two checkouts' outputs differ")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("flash", "l2", "acc", "packed",
                                         "all"), default="all")
    ap.add_argument("--against", default=None,
                    help="another checkout whose kernels run beside the "
                         "committed ones (--kernel acc, packed)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    which = ("flash", "l2", "acc", "packed") if args.kernel == "all" \
        else (args.kernel,)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(which, tmp)
        if "flash" in which:
            run_flash(libs, dev)
        if "l2" in which:
            run_l2(libs, dev)
        if "acc" in which:
            run_acc(libs, dev, args.against, tmp)
        if "packed" in which:
            run_packed(libs, dev, args.against, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
