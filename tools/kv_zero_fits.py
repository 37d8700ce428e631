#!/usr/bin/env python3
"""KV head fits that find no cluster (k* = 0): dump them on the card,
then fit the same keys with the same draws in the reference on the CPU.

    python tools/kv_zero_fits.py dump [--shared-case-generator] [--out F]
    PYTHONPATH=src:tests python tools/kv_zero_fits.py check [--dump F]

``dump`` (on the card) runs ``chip_smoke.py`` and saves, for every fit
of a ``LayerKVCluster`` head that returns k* = 0 (at most four), its
keys, values, the port's own draws (the QALSH matrix and the SILK table
keys), its seeds and config, to ``chiprun_out/kv_zero_fits.pt``; the
smoke then fails at phase 11, as it does on such a draw.
``--shared-case-generator`` replays the smoke with phase 6's packed edge
cases drawn from the smoke's shared generator instead of their own, which
gives phases 7-11 other inputs (the draw on which three heads' refresh
fits found no cluster).

``check`` (on the CPU, imports the reference) runs the reference's SILK
discovery on each dumped head's keys with the dumped draws, and the
port's fit with the same draws, and prints both k* and overflows.
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
OUT = os.path.join("chiprun_out", "kv_zero_fits.pt")


def dump(out, shared_case_generator):
    import torch
    from repro_torch.core import api
    from repro_torch.serve import kv_cluster as kv
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    if shared_case_generator:
        own = "case_gen = torch.Generator(device=dev).manual_seed(6)"
        if own not in src:
            raise RuntimeError("phase 6's own case generator not found")
        src = src.replace(own, "case_gen = gen")
    last, fits = {}, []
    split_key, fit_row = api.LSHBucketer.split_key, kv.LayerKVCluster._fit_row

    def recording_split_key(self, kind, gen, d, cfg):
        last["draws"] = split_key(self, kind, gen, d, cfg)
        return last["draws"]

    def dumping_fit_row(self, h, keys, values):
        fit_row(self, h, keys, values)
        if self.k_stars[h] == 0 and len(fits) < 4:
            _, (a,), table_keys = last["draws"]
            fits.append({"head": h, "fit": self._fits[h],
                         "seeds": self.seeds[h], "config": repr(self.gcfg),
                         "keys": torch.as_tensor(keys).float().cpu(),
                         "values": torch.as_tensor(values).float().cpu(),
                         "a": a.cpu(), "table_keys": table_keys.cpu()})
            os.makedirs(os.path.dirname(out), exist_ok=True)
            torch.save(fits, out)
            print(f"kv_zero_fits: seeds {self.seeds[h]}, fit {self._fits[h]}"
                  f": k* = 0, saved to {out}", flush=True)

    api.LSHBucketer.split_key = recording_split_key
    kv.LayerKVCluster._fit_row = dumping_fit_row
    smoke = {"__name__": "chip_smoke_replay",
             "__file__": os.path.join(ROOT, "chip_smoke.py")}
    exec(compile(src, "chip_smoke.py", "exec"), smoke)
    try:
        return smoke["main"]()
    finally:
        print(f"kv_zero_fits: {len(fits)} fit(s) with k* = 0 saved")


def check(path):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from _torch_parity import InjectedBucketer
    import repro_torch as rt
    from repro.core import lsh, silk
    from repro.core.buckets import partition_even
    from repro.serve import kv_cluster as jkv
    from repro_torch.serve import kv_cluster as tkv
    cfg = jkv.default_kv_config()
    seen = set()
    for f in torch.load(path):
        if (f["seeds"], f["fit"]) in seen:      # the same fit, another run
            continue
        seen.add((f["seeds"], f["fit"]))
        table_keys = jnp.asarray(
            (f["table_keys"].numpy() & 0xFFFFFFFF).astype(np.uint32))
        derive = silk.derive_hash_keys
        silk.derive_hash_keys = lambda key, shape: table_keys
        try:
            buckets = partition_even(lsh.qalsh_hash(
                jnp.asarray(f["keys"].numpy()), jnp.asarray(f["a"].numpy())),
                cfg.t)
            seeds, overflow = silk.silk_seeding(
                buckets, jax.random.PRNGKey(0), silk_k=cfg.silk_k,
                silk_l=cfg.silk_l, delta=cfg.delta, pair_cap=cfg.pair_cap,
                k_max=cfg.k_max)
        finally:
            silk.derive_hash_keys = derive
        est = rt.GEEK(tkv.default_kv_config(), bucketer=InjectedBucketer(
            a=f["a"], table_keys=f["table_keys"]), device="cpu")
        model = est.fit(rt.DenseData(f["keys"]), torch.Generator())
        print(f"seeds {f['seeds']} (seed, layer, head), fit {f['fit']}, "
              f"{f['keys'].shape[0]} keys: reference k* {int(seeds.k_star)}"
              f", overflow {int(overflow)}; port on the CPU k* "
              f"{int(model.k_star)}, overflow {int(est.result_.overflow)}")
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("dump", "check"))
    ap.add_argument("--shared-case-generator", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--dump", default=OUT)
    args = ap.parse_args()
    if args.mode == "dump":
        return dump(args.out, args.shared_case_generator)
    return check(args.dump)


if __name__ == "__main__":
    sys.exit(main())
