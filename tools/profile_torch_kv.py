#!/usr/bin/env python3
"""Where the time of the port's KV-clustered decode goes.

    PYTHONPATH=src python tools/profile_torch_kv.py [--arch qwen3_0_6b]
        [--prompt 2048] [--decode 64] [--k-max 64] [--refresh-every 32]
        [--device cuda]

Runs ``chip_smoke.py``'s phase-11 path: the architecture at full width
with weights drawn from seed 0, one sequence of random tokens, the
prefill, one ``OnlineKVCluster`` fit per (layer, kv head), the decode
steps with routing and EMA updates, and a refresh every
``--refresh-every`` steps. A short decode warms up (kernel builds, library
handles). Then three runs:

1. un-instrumented: ``clustered_decode``'s own synchronized stage clock
   (prefill, initial fits, decode steps, refresh) and its wall time;
2. instrumented: each stage wrapped by a synchronized host clock, nested
   stages inside their parents: the prefill's attention (the
   flash-attention kernel), the fits, and per decode step
   ``stack_heads``, the clustered attention (the centroid-attention kernel
   and its inputs' concatenation), the rest of the model step, and each
   head's ``update`` split into ``route`` (the L2 kernel) and the
   EMA (``ema_update`` + ``update_centers``);
3. under ``torch.profiler`` (card only), a few decode steps: the device's
   busy share of the wall time and the device time by kernel.

``--device cpu`` rehearses the script on the architecture's smoke config
(``--prompt 128 --decode 40 --k-max 16`` unless given); its times are the
CPU's and say nothing of the card.
"""
import argparse
import collections
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import repro_torch as rt  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import kv_cluster as kv  # noqa: E402


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed_stages(dev):
    """Wrap each stage so that its synchronized wall time accumulates.
    Returns (totals, calls, undo)."""
    totals, calls = collections.defaultdict(float), collections.Counter()
    patched = []

    def wrap(owner, name, label):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(dev)
            totals[label] += time.perf_counter() - t0
            calls[label] += 1
            return out

        setattr(owner, name, timed)
        patched.append((owner, name, fn))

    wrap(L, "cache_attention", "cache attention (prefill: flash_attention)")
    wrap(kv.OnlineKVCluster, "_fit", "GEEK fits (start and refresh)")
    wrap(kv, "stack_heads", "stack_heads")
    wrap(kv, "clustered_attention", "clustered attention (flash_centroid_attention)")
    wrap(kv.OnlineKVCluster, "update", "update (route + EMA + v_max)")
    wrap(kv.OnlineKVCluster, "route", "- route (predict: L2 kernel)")
    wrap(kv, "ema_update", "- ema_update")
    wrap(kv, "update_centers", "- update_centers")
    wrap(M, "decode_step", "model step (with clustered attention)")

    def undo():
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)

    return totals, calls, undo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--prompt", type=int, default=None)
    ap.add_argument("--decode", type=int, default=None)
    ap.add_argument("--k-max", type=int, default=None)
    ap.add_argument("--refresh-every", type=int, default=32)
    ap.add_argument("--profile-steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    full = dev.type == "cuda"
    prompt = args.prompt or (2048 if full else 128)
    decode = args.decode or (64 if full else 40)
    k_max = args.k_max or (64 if full else 16)
    cfg = rt.get_arch(args.arch, smoke=not full)
    gcfg = kv.default_kv_config(k_max)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = rt.init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt + decode),
                           generator=gen, device=dev)

    def run(n_decode):
        return kv.clustered_decode(params, cfg, tokens[:, :prompt + n_decode],
                                   prompt, gcfg=gcfg,
                                   refresh_every=args.refresh_every,
                                   device=dev)

    run(2)                                              # warm-up
    sync(dev)
    t0 = time.perf_counter()
    out = run(decode)
    wall = time.perf_counter() - t0
    sec = out["seconds"]
    steps = sum(sec["steps"])
    name = torch.cuda.get_device_name(0) if full else "cpu"
    print(f"device {dev} {name}; {cfg.name}: {cfg.num_layers} layers x "
          f"{cfg.num_kv_heads} kv heads, prompt {prompt}, {decode} decoded, "
          f"k_max {k_max}, refresh every {args.refresh_every}")
    print(f"un-instrumented: wall {wall:.3f} s; ppl {out['ppl']:.4f}, mean "
          f"k* {out['mean_k_star']:.2f}, compression {out['compression']:.2f}, "
          f"refreshes {out['refreshes']}")
    for label, s in (("prefill", sec["prefill"]), ("initial fits", sec["fits"]),
                     (f"{decode} decode steps", steps),
                     ("refresh", sec["refresh"])):
        print(f"  {label:40s} {s * 1e3:10.1f} ms  {100 * s / wall:5.1f} %")
    print(f"  per decode step {steps / decode * 1e3:.2f} ms")

    totals, calls, undo = timed_stages(dev)
    try:
        t0 = time.perf_counter()
        run(decode)
        sync(dev)
        wall_i = time.perf_counter() - t0
    finally:
        undo()
    print(f"instrumented (stages synchronized): wall {wall_i:.3f} s")
    for label, secs in totals.items():
        print(f"  {label:40s} {secs * 1e3:10.1f} ms {calls[label]:6d} calls  "
              f"{100 * secs / wall_i:5.1f} %")

    if not full:
        return 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n = args.profile_steps
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(n)
        sync(dev)
        wall_p = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy, reach = 0.0, float("-inf")        # union of device intervals, us
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy /= 1e6
    print(f"profiled prefill + fits + {n} decode steps: wall "
          f"{wall_p * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
          f"({100 * busy / wall_p:.1f} %), idle "
          f"{100 * (1 - busy / wall_p):.1f} %")
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == cuda),
                  reverse=True)
    for us, count, key in rows[:15]:
        print(f"  {us / 1e3:9.2f} ms {count:7d}x  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
