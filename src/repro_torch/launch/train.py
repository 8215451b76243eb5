"""Training driver (PyTorch counterpart of ``repro/launch/train.py``):
trains a reduced or full config on the synthetic Markov LM stream with
AdamW, a cosine schedule, global-norm clipping and a checkpoint at the
end. ``repro_torch.train_lm`` drives it for the ~100M-parameter run.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 200 --batch 8 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --steps 5 --device cpu

Runs on the CUDA device unless ``--device`` names another. The
reference's ``--lower-only`` mode (the production-mesh lowering) is XLA's
and has no counterpart here.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as mdl
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.lm_data import MarkovLM
from repro_torch.train.optim import cosine_schedule


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
               seed: int = 0, log_every: int = 20, ckpt_path=None,
               moe_mode: str = "dense", d_model_vocab_cap: int | None = 8192,
               device: DeviceLike = None):
    """``steps`` AdamW steps (weight decay 0.1, clip 1.0, cosine schedule
    with ``max(10, steps // 20)`` warmup steps) on batches of ``batch`` ×
    ``seq`` tokens of a Markov stream over ``min(cfg.vocab,
    d_model_vocab_cap)`` tokens, from weights drawn with ``seed``. Saves
    ``{"params", "step"}`` to ``ckpt_path`` when given. Returns (params,
    the loss of every step)."""
    dev = resolve_device(device)
    vocab = min(cfg.vocab, d_model_vocab_cap or cfg.vocab)
    data = MarkovLM(vocab, seed=seed)
    params = mdl.init_params(seed, cfg, device=dev)
    step, opt = make_train_step(
        cfg, moe_mode=moe_mode, q_chunk=min(512, seq),
        lr=cosine_schedule(lr, warmup=max(10, steps // 20), total=steps))
    opt_state = opt.init(params)

    it = data.batches(batch, seq)
    hist = []
    t0 = time.time()
    for s in range(steps):
        b = {k: torch.as_tensor(np.minimum(v, cfg.vocab - 1), device=dev)
             for k, v in next(it).items()}
        params, opt_state, loss = step(params, opt_state, b)
        hist.append(float(loss))
        if s % log_every == 0 or s == steps - 1:
            print(f"step {s:5d}  loss {hist[-1]:.4f}  "
                  f"({(time.time()-t0)/(s+1):.2f}s/step)")
    if ckpt_path:
        ckpt.save(ckpt_path, {"params": params, "step": steps})
        print("saved checkpoint →", ckpt_path)
    return params, hist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _, hist = train_loop(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, lr=args.lr, ckpt_path=args.ckpt,
                         device=args.device)
    print(f"final loss {hist[-1]:.4f} (start {hist[0]:.4f})")
    return hist


if __name__ == "__main__":
    main()
