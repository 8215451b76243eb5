"""Step accounting of every (arch × input shape) on the meta device
(PyTorch counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each step on 512 placeholder TPU
devices and parses the HLO. The port keeps the purpose and not the
mechanism: it builds the whole parameter tree and the step's inputs on
the meta device (shapes and dtypes, nothing allocated, no GPU needed),
runs ``launch/steps.py``'s step once under ``op_analysis.OpCosts`` and
records, per combo, one JSONL row:

  * ``n_params``, ``n_active`` (MoE experts scaled by top_k / E) and
    ``model_flops`` = (6 for train, 2 otherwise) · n_active · tokens;
  * ``counted_flops`` and ``op_bytes`` (``OpCosts``), and
    ``useful_flops_ratio`` = model_flops / counted_flops;
  * ``min_bytes``, the least traffic of the step:
      - train: the parameters read and written, the gradients written
        and read, both f32 moment trees read and written, the batch read;
      - prefill: the parameters read, the batch read, the decode cache
        written (decode-capable archs) and the last-token logits written;
      - decode: the parameters read, the whole cache read, the new
        position's K/V (or SSM state) written, the tokens read and the
        logits written;
  * ``state_bytes_global`` (parameters + optimizer state for train,
    parameters for prefill, parameters + cache for decode) and
    ``state_bytes_per_device`` under ``launch/specs.py``'s layouts on a
    ``--mesh data=D,model=M`` of H100s (default 1 × 1), with ``fits``
    against the card's memory;
  * the roofline terms on the H100's data sheet (``launch/mesh.py``):
    on one device the step's own count; on a mesh, the count split
    evenly over its devices with ``collective_s`` null (nothing ran
    there);
  * ``status`` (``ok`` / ``skipped`` with the reason / ``error`` with the
    message) and ``seconds``.

Decode shapes are skipped for encoder-only archs; ``long_500k`` decodes
through the sliding-window rolling cache on pure-attention archs.
Reruns skip combos already in the file (``--force`` redoes them).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --mesh data=2,model=4
  PYTHONPATH=src python -m repro_torch.launch.roofline
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Optional

import torch

from repro_torch.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import H100, device_peaks
from repro_torch.launch.op_analysis import OpCosts, roofline_terms
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import model as mdl

RESULTS = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch.jsonl")

PURE_ATTENTION = {"dense", "moe", "vlm"}


def combo_skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    if INPUT_SHAPES[shape_name].kind == "decode" and not cfg.supports_decode:
        return "encoder-only: no decode step"
    return None


def parse_mesh(text: str) -> dict:
    """``"data=2,model=4"`` → ``{"data": 2, "model": 4}``."""
    out = {}
    for part in text.split(","):
        name, _, size = part.partition("=")
        out[name.strip()] = int(size)
    return out


def mesh_name(mesh_shape: dict) -> str:
    return "x".join(str(v) for v in mesh_shape.values())


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a nested dict."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def abstract_params(cfg: ModelConfig) -> dict:
    """The whole parameter tree on the meta device."""
    return mdl.init_params(0, cfg, device="meta")


def count_step(cfg: ModelConfig, shape: InputShape, params: dict, inputs,
               *, q_chunk: int = 512, attn_layout: str = "grouped",
               rolling: bool = False):
    """Run one step of ``shape.kind`` under ``OpCosts``; returns
    (OpCosts, optimizer state or None). Works on any device. MoE layers
    run the dense dispatch, as every serving path does (the capacity
    dispatch's shapes depend on the routing, which the meta device does
    not have)."""
    opt_state = None
    with OpCosts() as costs:
        if shape.kind == "train":
            step, opt = make_train_step(cfg, q_chunk=q_chunk,
                                        attn_layout=attn_layout)
            opt_state = opt.init(params)
            step(params, opt_state, inputs)
        elif shape.kind == "prefill":
            make_prefill_step(cfg, q_chunk=q_chunk,
                              attn_layout=attn_layout)(params, inputs)
        else:
            make_decode_step(cfg, rolling=rolling)(
                params, inputs["cache"], inputs["tokens"], inputs["pos"])
    return costs, opt_state


def min_bytes(cfg: ModelConfig, shape: InputShape, params: dict, inputs,
              opt_state=None) -> int:
    """The least traffic of one step (see the module doc)."""
    p = tree_bytes(params)
    if shape.kind == "train":
        moments = tree_bytes(opt_state.m) + tree_bytes(opt_state.v)
        return 2 * p + 2 * p + 2 * moments + tree_bytes(inputs)
    esz = 2 if cfg.dtype == "bfloat16" else 4
    B = shape.global_batch
    if shape.kind == "prefill":
        cache = (tree_bytes(mdl.init_decode_cache(cfg, B, shape.seq_len,
                                                  device="meta"))
                 if cfg.supports_decode else 0)
        return p + tree_bytes(inputs) + cache + B * cfg.vocab * esz
    cache = tree_bytes(inputs["cache"])
    # what one position writes: a K/V row per attention layer, the whole
    # (conv, state) of an SSM layer
    one = tree_bytes(mdl.init_decode_cache(cfg, B, 1, device="meta"))
    return (p + cache + one + tree_bytes(inputs["tokens"])
            + B * cfg.vocab * esz)


def run_combo(arch: str, shape_name: str, *,
              mesh_shape: Optional[dict] = None, q_chunk: int = 512,
              attn_layout: str = "grouped",
              tag: str = "baseline", params: Optional[dict] = None) -> dict:
    """Account one combo on the meta device; returns its record.
    ``params`` may pass the arch's meta tree built once for all shapes."""
    t0 = time.perf_counter()
    mesh_shape = dict(mesh_shape or {"data": 1, "model": 1})
    n_dev = 1
    for v in mesh_shape.values():
        n_dev *= v
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh_shape),
           "device": H100, "q_chunk": q_chunk,
           "attn_layout": attn_layout, "tag": tag}
    skip = combo_skip_reason(cfg, shape_name)
    if skip:
        rec.update(status="skipped", reason=skip,
                   seconds=time.perf_counter() - t0)
        return rec
    shape = INPUT_SHAPES[shape_name]
    rolling = shape.name == "long_500k" and cfg.arch_type in PURE_ATTENTION
    if rolling:
        shape = InputShape(shape.name, cfg.sliding_window,
                           shape.global_batch, shape.kind)
    params = params if params is not None else abstract_params(cfg)
    inputs, in_lay = SP.input_shapes(cfg, shape, mesh_shape)
    costs, opt_state = count_step(cfg, shape, params, inputs,
                                  q_chunk=q_chunk,
                                  attn_layout=attn_layout, rolling=rolling)
    n_params = mdl.param_count(params)
    n_active = mdl.active_param_count(params, cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    p_lay = SP.param_layouts(mesh_shape, cfg, params)
    state = tree_bytes(params)
    per_dev = SP.per_device_bytes(params, p_lay, mesh_shape)
    if shape.kind == "train":
        for tree in (opt_state.m, opt_state.v):
            state += tree_bytes(tree)
            per_dev += SP.per_device_bytes(tree, p_lay, mesh_shape)
        state += opt_state.step.numel() * opt_state.step.element_size()
    elif shape.kind == "decode":
        state += tree_bytes(inputs["cache"])
        per_dev += SP.per_device_bytes(inputs["cache"], in_lay["cache"],
                                       mesh_shape)
    peaks = device_peaks(H100)
    tot = costs.totals()
    split = {"flops": tot["flops"] / n_dev, "op_bytes": tot["op_bytes"] / n_dev,
             "collective_bytes": tot["collective_bytes"],
             "collectives": tot["collectives"]}
    terms = roofline_terms(split, peaks, cfg.dtype, n_devices=n_dev)
    rec.update(
        status="ok", rolling=rolling, n_params=n_params, n_active=n_active,
        model_flops=model_flops, counted_flops=tot["flops"],
        useful_flops_ratio=(model_flops / tot["flops"] if tot["flops"]
                            else None),
        op_bytes=tot["op_bytes"],
        min_bytes=min_bytes(cfg, shape, params, inputs, opt_state),
        state_bytes_global=state, state_bytes_per_device=per_dev,
        fits=per_dev <= peaks["memory_bytes"],
        kernels=costs.kernels,
        compute_s=terms["compute_s"], memory_s=terms["memory_s"],
        collective_s=terms["collective_s"], dominant=terms["dominant"],
        seconds=time.perf_counter() - t0)
    return rec


def _key(r: dict) -> tuple:
    return (r["arch"], r["shape"], r["mesh"], r.get("device"),
            r.get("tag", "baseline"))


def load_done(path=RESULTS) -> dict:
    done = {}
    if path.exists():
        for line in path.read_text().splitlines():
            if line.strip():
                r = json.loads(line)
                done[_key(r)] = r
    return done


def append(rec: dict, path=RESULTS) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def run_all(combos, *, mesh_shape=None, tag: str = "baseline",
            force: bool = False, path=RESULTS, verbose: bool = True,
            **kw) -> list:
    """Account every (arch, shape) of ``combos`` not already in ``path``
    (every one with ``force``), appending each record; returns the
    records of this call, cached ones included. A combo that raises is
    recorded with status ``error`` and its message."""
    mesh_shape = dict(mesh_shape or {"data": 1, "model": 1})
    done = {} if force else load_done(path)
    out, trees = [], {}
    for a, s in combos:
        key = (a, s, mesh_name(mesh_shape), H100, tag)
        if key in done and done[key]["status"] != "error":
            out.append(done[key])
            continue
        t0 = time.perf_counter()
        try:
            if a not in trees:
                trees = {a: abstract_params(get_config(a))}
            rec = run_combo(a, s, mesh_shape=mesh_shape, tag=tag,
                            params=trees[a], **kw)
        except Exception as e:  # recorded: a combo that fails is a bug
            rec = {"arch": a, "shape": s, "mesh": mesh_name(mesh_shape),
                   "device": H100, "tag": tag, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "seconds": time.perf_counter() - t0}
        if verbose:
            print(json.dumps({k: rec.get(k) for k in (
                "arch", "shape", "status", "counted_flops", "op_bytes",
                "dominant", "seconds", "reason", "error")}), flush=True)
        append(rec, path)
        out.append(rec)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="data=1,model=1",
                    help="mesh shape, e.g. data=16,model=16")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--attn-layout", default="grouped",
                    choices=["grouped", "flat"])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("name --arch and/or --shape, or pass --all")
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    recs = run_all([(a, s) for a in archs for s in shapes],
                   mesh_shape=parse_mesh(args.mesh), tag=args.tag,
                   force=args.force, q_chunk=args.q_chunk,
                   attn_layout=args.attn_layout)
    tally = {s: sum(r["status"] == s for r in recs)
             for s in ("ok", "skipped", "error")}
    print(json.dumps({"dryrun": tally}))
    return recs


if __name__ == "__main__":
    main()
