#!/usr/bin/env python3
"""Where the time of the port's KV-clustered decode goes.

    PYTHONPATH=src python tools/profile_torch_kv.py [--arch qwen3_0_6b]
        [--layers N] [--prompt 2048] [--decode 64] [--k-max 64]
        [--refresh-every 32] [--device cuda]

Runs ``chip_smoke.py``'s phase-11 path (``--arch jamba_v0_1_52b --layers
8``: phase 16(a)'s, Jamba cut to one period of its interleave): the
architecture at full width (its first ``--layers`` layers, if given)
with weights drawn from seed 0, one sequence of random tokens, the
prefill, one ``LayerKVCluster`` per layer (a fit per kv head), the decode
steps (clustered attention on the decode routine, then one launch of the
absorb kernel a layer: route + EMA), and a refresh every ``--refresh-every``
steps. A short decode warms up (kernel builds, library handles). Then
four runs:

1. un-instrumented, the step replayed from its CUDA graph (the default):
   ``clustered_decode``'s own synchronized stage clock (prefill, initial
   fits, decode steps, refresh) and its wall time;
2. the same with the step eager (``cuda_graph=False``): what the graph
   saves;
3. instrumented, eager (a graph replay calls no Python): each stage
   wrapped by a synchronized host clock, nested stages inside their
   parents: the prefill's attention (the flash-attention kernel), the
   Mamba mixer (its selective scan), the MoE layer (its dispatch and
   combine) and the RWKV6 mixes where the plan has them, the
   fits, and per decode step the model step, the centroid attention (the
   decode routine), and each layer's ``absorb`` (the absorb kernel; with
   ``--swap-kernels``' unfused absorb, the route and the EMA apart);
4. under ``torch.profiler`` (card only), a few decode steps replayed: the
   device's busy share of the whole run and of the decode steps alone
   (the first, which captures, left out), and the device time by kernel.

``--swap-kernels`` runs instead the run of 1 (the step replayed) and the
same run with the step's kernels swapped: the absorb kernel for the
unfused absorb (the head-batched route kernel, then the plain EMA); the
decode kernel for the (B, S) centroid-attention kernel over a snapshot;
and both, with one L2 launch a head in place of the head-batched route
(the per-head step's calls). It prints each run's perplexity, mean k*
and decode step mean and median, so that one call gives the fused and
the unfused step and a change of the perplexity can be put down to a
kernel.

``--device cpu`` rehearses the script on the architecture's smoke config
(``--prompt 128 --decode 40 --k-max 16`` unless given); its times are the
CPU's and say nothing of the card.
"""
import argparse
import collections
import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import repro_torch as rt  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MoE  # noqa: E402
from repro_torch.models import rwkv6 as R  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
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
    wrap(SSM, "mamba_apply", "Mamba mixer")
    wrap(SSM, "_ssm_scan", "- selective scan")
    wrap(MoE, "moe_apply", "MoE feed-forward")
    wrap(MoE, "_dispatch_local", "- MoE dispatch (top-k, sort, scatter)")
    wrap(MoE, "_combine_local", "- MoE combine")
    wrap(R, "rwkv_time_mix", "RWKV6 time mix")
    wrap(R, "rwkv_channel_mix", "RWKV6 channel mix")
    wrap(kv.LayerKVCluster, "_fit_row",
         "GEEK fits (start and refresh), per head")
    wrap(M, "decode_step", "model step (with clustered attention, absorb)")
    wrap(kv.kops, "flash_centroid_decode",
         "- centroid attention (decode routine)")
    wrap(kv.LayerKVCluster, "absorb", "- absorb, per layer: route + EMA")
    wrap(kv.kops, "l2_absorb_heads", "-- absorb kernel")
    wrap(kv.kops, "distance_argmin_l2_heads",
         "-- route (head-batched L2 kernel; unfused only)")
    wrap(kv, "_ema", "-- EMA, all heads of the layer (unfused only)")

    def undo():
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)

    return totals, calls, undo


def swap_kernels(which):
    """Swap the step's kernels: with "absorb" in ``which`` the absorb
    kernel for ``kv_cluster.absorb_plain`` (the head-batched route, then
    the plain EMA); with "attention" the decode kernel for
    ``clustered_attention`` over a snapshot with ``head_state``'s log-mass
    (the (B, S) kernel); with "route" the head-batched route for one
    ``distance_argmin_l2`` a head (‖c‖² computed per head in its wrapper).
    Returns undo."""
    saved = (kv.kops.flash_centroid_decode, kv.kops.distance_argmin_l2_heads,
             kv.kops.l2_absorb_heads)

    def attention(q, centers, v_cent, mass, valid, extra_k=None,
                  extra_v=None):
        live = valid & (mass > 0)
        lm = torch.where(live, torch.log(torch.clamp(mass, min=1e-9)), -1e30)
        return kv.clustered_attention(q, kv.KVState(centers, v_cent, lm),
                                      extra_k=extra_k, extra_v=extra_v)

    def route(x, centers, csq, valid):
        outs = [kv.kops.distance_argmin_l2(x[h], centers[h], valid[h])
                for h in range(x.shape[0])]
        return tuple(torch.stack(parts) for parts in zip(*outs))

    def absorb(keys, values, *state, ema, decay):
        return kv.absorb_plain(keys, values, *state, ema=ema)

    if "attention" in which:
        kv.kops.flash_centroid_decode = attention
    if "route" in which:
        kv.kops.distance_argmin_l2_heads = route
    if "absorb" in which:
        kv.kops.l2_absorb_heads = absorb

    def undo():
        (kv.kops.flash_centroid_decode, kv.kops.distance_argmin_l2_heads,
         kv.kops.l2_absorb_heads) = saved
    return undo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers (Jamba: 8, one period)")
    ap.add_argument("--prompt", type=int, default=None)
    ap.add_argument("--decode", type=int, default=None)
    ap.add_argument("--k-max", type=int, default=None)
    ap.add_argument("--refresh-every", type=int, default=32)
    ap.add_argument("--profile-steps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--swap-kernels", action="store_true")
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
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    gcfg = kv.default_kv_config(k_max)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = rt.init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, prompt + decode),
                           generator=gen, device=dev)

    def run(n_decode, graph=True):
        return kv.clustered_decode(params, cfg, tokens[:, :prompt + n_decode],
                                   prompt, gcfg=gcfg,
                                   refresh_every=args.refresh_every,
                                   device=dev, cuda_graph=graph)

    run(2)                                              # warm-up
    name = torch.cuda.get_device_name(0) if full else "cpu"
    print(f"device {dev} {name}; {cfg.name}: {cfg.num_layers} layers x "
          f"{cfg.num_kv_heads} kv heads, prompt {prompt}, {decode} decoded, "
          f"k_max {k_max}, refresh every {args.refresh_every}")
    if args.swap_kernels:
        for which in ((), ("absorb",), ("attention",),
                      ("attention", "absorb", "route")):
            undo = swap_kernels(which)
            try:
                out = run(decode)
            finally:
                undo()
            steps = torch.tensor(out["seconds"]["steps"][1:]) * 1e3
            print(f"{'replayed' if full else 'eager'}, swapped: "
                  f"{', '.join(which) or 'nothing'}: ppl {out['ppl']:.6f}, "
                  f"mean k* {out['mean_k_star']:.2f}, k* per head "
                  f"{sum(out['k_stars'])} in all; decode step (after the "
                  f"first) mean {float(steps.mean()):.3f} ms, median "
                  f"{float(steps.median()):.3f} ms")
        return 0
    for graph in (True, False):
        sync(dev)
        t0 = time.perf_counter()
        out = run(decode, graph)
        wall = time.perf_counter() - t0
        sec = out["seconds"]
        steps = sum(sec["steps"])
        how = "replayed" if graph and full else "eager"
        print(f"un-instrumented, step {how}: "
              f"wall {wall:.3f} s; ppl {out['ppl']:.6f}, mean k* "
              f"{out['mean_k_star']:.2f}, compression "
              f"{out['compression']:.2f}, refreshes {out['refreshes']}")
        for label, s in (("prefill", sec["prefill"]),
                         ("initial fits", sec["fits"]),
                         (f"{decode} decode steps", steps),
                         ("refresh", sec["refresh"])):
            print(f"  {label:40s} {s * 1e3:10.1f} ms  {100 * s / wall:5.1f} %")
        print(f"  per decode step {steps / decode * 1e3:.3f} ms (the first "
              f"{sec['steps'][0] * 1e3:.2f} ms"
              f"{', with the capture' if graph and full else ''})")

    totals, calls, undo = timed_stages(dev)
    try:
        t0 = time.perf_counter()
        run(decode, graph=False)
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
    # device intervals; the step's range on the device's timeline (its
    # annotation) is not device work
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == cuda and e.name != kv.STEP_SPAN)
    busy, reach = 0.0, float("-inf")        # union of device intervals, us
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy /= 1e6
    print(f"profiled prefill + fits + {n} decode steps: wall "
          f"{wall_p * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
          f"({100 * busy / wall_p:.1f} %), idle "
          f"{100 * (1 - busy / wall_p):.1f} %")
    steps = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name == kv.STEP_SPAN and e.device_type != cuda)[1:]
    work = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events()
                  if e.device_type == cuda and e.name != kv.STEP_SPAN)
    in_steps, names = 0.0, collections.Counter()
    for s0, s1 in steps:
        reach = s0
        for start, end, key in work:
            if s0 <= start < s1:
                in_steps += max(0.0, end - max(start, reach))
                reach = max(reach, end)
                names[key] += 1
    wall_s = sum(s1 - s0 for s0, s1 in steps)
    if wall_s:
        print(f"  decode steps 2-{n}: wall {wall_s / 1e3:.3f} ms, device "
              f"busy {in_steps / 1e3:.3f} ms ({100 * in_steps / wall_s:.1f} "
              f"%), {sum(names.values()) / len(steps):.0f} device events a "
              f"step; the most frequent, a step:")
        for key, count in names.most_common(12):
            print(f"  {count / len(steps):9.1f}x  {key[:90]}")
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages() if e.device_type == cuda),
                  reverse=True)
    for us, count, key in rows[:15]:
        print(f"  {us / 1e3:9.2f} ms {count:7d}x  {key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
