"""Batched serving driver: prefill + greedy decode loop (the counterpart
of ``repro.launch.serve``).

Prefills the prompts into caches with room for the generated tokens (on
the card: one launch of the flash-attention kernel per attention layer),
then decodes greedily one token a step; stub frontends (vlm/audio)
decode over drawn embeddings. Every step's logits must be finite.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch qwen3_0_6b --smoke --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_0_6b \\
      --prompt-len 2048                                   # on the card
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.models import decode_step, forward, init_params
from repro_torch.models import model as MODEL
from repro_torch.models import transformer as T
from repro_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cuda (raises without a card)")
    return ap


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(args, *, params=None, log=print) -> dict:
    """Run ``args`` (``build_parser``'s), on ``params`` when given (else
    drawn from ``--seed``). Returns ``{"params", "inputs", "tokens",
    "logits", "prefill_s", "decode_s"}``: every input the model was fed
    (the prompts, then each decode step's token or embedding), the
    greedy tokens (B, gen) and the last step's float32 logits."""
    device = resolve_device(args.device)
    cfg = get_arch(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if params is None:
        params = init_params(cfg, gen, device=device)
    B, S, G = args.batch, args.prompt_len, args.gen
    embeds = not MODEL.has_token_embed(cfg)
    if embeds:
        prompts = torch.randn((B, S, cfg.d_model), generator=gen,
                              device=device)
    else:
        prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                device=device)

    # prefill into a cache with room for the generated tokens
    _sync(device)
    t0 = time.perf_counter()
    caches = T.stack_cache_init(cfg, B, S + G, device)
    x, caches, _ = forward(params, cfg, prompts, caches=caches, cache_len=0)
    logits = (x[:, -1] @ params["head"]["w"]).to(torch.float32)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits after the prefill")
    log(f"[serve] prefill {B}x{S}: {t_prefill*1e3:.1f} ms "
        f"({B*S/t_prefill:.0f} tok/s)")

    toks = torch.argmax(logits, -1)[:, None]
    out, fed = [toks], [prompts]
    t0 = time.perf_counter()
    for i in range(G - 1):
        if embeds:          # stub frontends decode over drawn embeddings
            tok_in = torch.randn((B, 1, cfg.d_model), generator=gen,
                                 device=device)
        else:
            tok_in = toks
        logits, caches = decode_step(params, cfg, caches, S + i, tok_in)
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError(f"non-finite logits at decode step {i}")
        toks = torch.argmax(logits, -1)[:, None]
        out.append(toks)
        fed.append(tok_in)
    _sync(device)
    t_dec = time.perf_counter() - t0
    steps = max(G - 1, 1)
    log(f"[serve] decode {G-1} steps: {t_dec/steps*1e3:.1f} ms/tok "
        f"({B*(G-1)/max(t_dec, 1e-9):.0f} tok/s aggregate)")
    seq = torch.cat(out, dim=1)
    log(f"[serve] sample continuation (batch 0): {seq[0].tolist()}")
    return {"params": params, "inputs": torch.cat(fed, dim=1), "tokens": seq,
            "logits": logits, "prefill_s": t_prefill, "decode_s": t_dec}


def main(argv=None) -> None:
    serve(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
