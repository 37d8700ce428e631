#!/usr/bin/env python3
"""What holds a hand-written kernel back: variants of its source, timed.

    python tools/kernel_variants.py [--kernel flash|l2|all]

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

Variants that drop work are for timing only: they break the function.
Needs the card and ``nvcc``; the variants' libraries go to a temporary
directory that is removed at exit.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import distance_argmin as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

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
        entry = ("flash_attention_bf16_kernelILi64" if key[0] == "flash"
                 else "l2_argmin_kernelILb1")
        lines = out.splitlines()
        regs = next((f"{lines[i + 3].split(':')[-1].strip()}; "
                     f"{lines[i + 2].strip()}"
                     for i, line in enumerate(lines[:-3]) if entry in line), "")
        print(f"  built {key[0]} '{key[1]}': {regs}", flush=True)
        libs[key] = lib
    return libs


def device_ms(fn, iters, match):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if match in e.key) / iters / 1e3


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("flash", "l2", "all"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    which = ("flash", "l2") if args.kernel == "all" else (args.kernel,)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(which, tmp)
        if "flash" in which:
            run_flash(libs, dev)
        if "l2" in which:
            run_l2(libs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
