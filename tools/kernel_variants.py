#!/usr/bin/env python3
"""What holds a hand-written kernel back: variants of its source, timed.

    python tools/kernel_variants.py [--kernel flash|l2|acc|all]
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
                 "acc": "l2_argmin_acc_kernelILb1"}[key[0]]
        lines = out.splitlines()
        regs = next((f"{lines[i + 3].split(':')[-1].strip()}; "
                     f"{lines[i + 2].strip()}"
                     for i, line in enumerate(lines[:-3]) if entry in line), "")
        print(f"  built {key[0]} '{key[1]}': {regs}", flush=True)
        libs[key] = lib
    return libs


def device_ms(fn, iters, match):
    """Device ms a call in the kernels whose name holds ``match`` (a
    string, or a tuple of strings any of which may match)."""
    from torch.profiler import ProfilerActivity, profile
    match = match if isinstance(match, tuple) else (match,)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if any(m in e.key for m in match)) / iters / 1e3


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("flash", "l2", "acc", "all"),
                    default="all")
    ap.add_argument("--against", default=None,
                    help="another checkout whose accumulating kernel runs "
                         "beside the committed one (--kernel acc)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 1
    which = ("flash", "l2", "acc") if args.kernel == "all" \
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
