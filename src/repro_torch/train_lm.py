"""End-to-end LM training driver of the PyTorch port (the twin of
``examples/train_lm.py``).

Trains a ~100M-parameter dense GQA model on the synthetic Markov LM
stream for a few hundred steps with the full substrate: the unit-stacked
model with per-unit recomputation, AdamW + cosine schedule + clipping,
and a checkpoint. ``--quick`` shrinks the model and the steps.

  PYTHONPATH=src python -m repro_torch.train_lm            # on the GPU
  PYTHONPATH=src python -m repro_torch.train_lm --quick --device cpu

Runs on the CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.config import ModelConfig
from repro_torch.launch.train import train_loop

# ~126M params: 12L · d768 · ff3072 · 8k vocab
CFG_100M = ModelConfig(
    name="repro-100m", arch_type="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_ff=3072, vocab=8192, head_dim=64,
    dtype="float32")

CFG_QUICK = dataclasses.replace(
    CFG_100M, name="repro-12m", n_layers=4, d_model=256, d_ff=1024,
    n_heads=8, n_kv_heads=4, head_dim=32, vocab=2048)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm.msgpack"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    cfg = CFG_QUICK if args.quick else CFG_100M
    steps = args.steps or (60 if args.quick else 300)
    batch, seq = (8, 128) if args.quick else (16, 512)
    from repro_torch.models.model import init_params, param_count
    n = param_count(init_params(0, cfg, device=args.device))
    print(f"model {cfg.name}: {n/1e6:.1f}M params, {steps} steps, "
          f"batch {batch} × seq {seq}")
    _, hist = train_loop(cfg, steps=steps, batch=batch, seq=seq, lr=1e-3,
                         ckpt_path=args.ckpt, device=args.device)
    print(f"loss {hist[0]:.3f} → {hist[-1]:.3f} "
          f"({'improved' if hist[-1] < hist[0] else 'NO IMPROVEMENT'})")
    return hist


if __name__ == "__main__":
    main()
