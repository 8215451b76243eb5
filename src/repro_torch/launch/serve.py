"""Serving driver: prefill + batched greedy decode for one pool model
(PyTorch counterpart of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --batch 4 --prompt-len 32 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu

Runs on the CUDA device unless ``--device`` names another; there every
decode step runs the ``decode_attention`` kernel. The prompt tokens are
drawn from a generator seeded 0 on the device, so they differ from the
reference's ``jax.random`` prompt.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import model as mdl
from repro_torch.serve.kv_cache import extend_cache


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def run(cfg, *, batch: int = 4, prompt_len: int = 32, new_tokens: int = 16,
        device: DeviceLike = None) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens with
    weights drawn from seed 0, then ``new_tokens`` greedy decode steps
    through ``make_decode_step``. Returns the tokens (B, new_tokens + 1)
    and the prefill and decode seconds."""
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only — no decode path")
    dev = resolve_device(device)
    params = mdl.init_params(0, cfg, device=dev)
    B, S, T = batch, prompt_len, new_tokens
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, _, cache = mdl.forward(params, cfg, tokens=toks,
                                   logits_last_only=True, return_cache=True,
                                   q_chunk=min(512, S))
    cache = extend_cache(cache, S + T)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    print(f"prefill {B}×{S}: {prefill_s:.2f}s")

    step = make_decode_step(cfg)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for t in range(T):
        logits_t, cache = step(params, cache, tok, S + t)
        tok = torch.argmax(logits_t[:, 0], -1)[:, None].to(torch.int32)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    print(f"decode {T} tokens × {B} seqs: {decode_s:.2f}s "
        f"({B*T/decode_s:.1f} tok/s)")
    tokens = torch.cat(out, 1)
    print(f"sample: {tokens[0].tolist()}")
    return {"tokens": tokens, "prefill_s": prefill_s, "decode_s": decode_s,
            "tok_per_s": B * T / decode_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return run(cfg, batch=args.batch, prompt_len=args.prompt_len,
               new_tokens=args.new_tokens, device=args.device)


if __name__ == "__main__":
    main()
