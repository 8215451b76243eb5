"""Random weights for a pool model and its router, made by the benchmark
from the run's seed and handed alike to the port and to the reference.

A model's parameters are in the port's tree (``params["blocks"]["l0"]``
holds every layer stacked on a leading axis; weights are (in, out)). Each
leaf is one tensor made on the device in the served dtype and filled by
one ``normal_`` call from a generator seeded by (seed, model, leaf), so a
whole model takes a few large calls and any leaf can be made again alike.
Norm scales draw around 1 and biases around 0, so that neither is a no-op
the comparison could not see.

The router's state is drawn on the CPU from the configuration's own
router seed: the same router in every run, so the routing of the mix's
fixed request set is the same in every run (``traffic/gen.py``).

Imports torch and numpy only.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

#: (path, shape, dtype name or None for the served dtype, init, scale):
#: init "normal" draws scale · N(0, 1), "one" 1 + scale · N(0, 1)
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], object, str, float]


def is_moe(m: dict) -> bool:
    return int(m.get("num_local_experts", 0)) > 0


def leaf_specs(m: dict) -> List[Leaf]:
    """Every parameter leaf of pool model ``m`` (a model entry of a
    configuration file) in the port's tree."""
    L, d = m["num_hidden_layers"], m["hidden_size"]
    hq, hkv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                   m["head_dim"])
    f, V = m["intermediate_size"], m["vocab_size"]
    blk = ("blocks", "l0")
    out: List[Leaf] = [
        (("embed", "tok"), (V, d), None, "normal", 0.02),
        (("embed", "unembed"), (d, V), None, "normal", d ** -0.5),
        (("final_norm", "scale"), (d,), None, "one", 0.1),
        (blk + ("norm1", "scale"), (L, d), None, "one", 0.1),
        (blk + ("mixer", "wq"), (L, d, hq * hd), None, "normal", d ** -0.5),
        (blk + ("mixer", "wk"), (L, d, hkv * hd), None, "normal", d ** -0.5),
        (blk + ("mixer", "wv"), (L, d, hkv * hd), None, "normal", d ** -0.5),
        (blk + ("mixer", "wo"), (L, hq * hd, d), None, "normal",
         (hq * hd) ** -0.5),
    ]
    if m.get("qkv_bias"):
        out += [(blk + ("mixer", b), (L, w), None, "normal", 0.02)
                for b, w in (("bq", hq * hd), ("bk", hkv * hd),
                             ("bv", hkv * hd))]
    out.append((blk + ("norm2", "scale"), (L, d), None, "one", 0.1))
    if is_moe(m):
        E = m["num_local_experts"]
        out += [(blk + ("ffn", "router"), (L, d, E), "float32", "normal",
                 d ** -0.5),
                (blk + ("ffn", "wg"), (L, E, d, f), None, "normal", d ** -0.5),
                (blk + ("ffn", "wu"), (L, E, d, f), None, "normal", d ** -0.5),
                (blk + ("ffn", "wd"), (L, E, f, d), None, "normal", f ** -0.5)]
    else:
        out += [(blk + ("ffn", "wg"), (L, d, f), None, "normal", d ** -0.5),
                (blk + ("ffn", "wu"), (L, d, f), None, "normal", d ** -0.5),
                (blk + ("ffn", "wd"), (L, f, d), None, "normal", f ** -0.5)]
    return out


def leaf_seed(seed: int, model_index: int, path: Tuple[str, ...]) -> int:
    """The generator seed of one leaf: any run seed (a large one too),
    model and leaf map to a distinct 63-bit seed."""
    tag = zlib.crc32("/".join(path).encode())
    mixed = (int(seed) * 1_000_003 + model_index * 7_919 + tag)
    return mixed % (2 ** 63 - 1)


def make_leaf(spec: Leaf, m: dict, seed: int, model_index: int,
              device) -> torch.Tensor:
    path, shape, dt, init, scale = spec
    dtype = DTYPES[dt or m["torch_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, model_index, path))
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(1.0 if init == "one" else 0.0, scale, generator=gen)


def make_params(m: dict, seed: int, model_index: int, device) -> dict:
    """Pool model ``m``'s parameters in the port's tree, on ``device``."""
    params: Dict = {}
    for spec in leaf_specs(m):
        node = params
        for k in spec[0][:-1]:
            node = node.setdefault(k, {})
        node[spec[0][-1]] = make_leaf(spec, m, seed, model_index, device)
    return params


def router_state(r: dict, costs, device) -> dict:
    """The MLP router's state (the port's tree: ``trunk`` layers of w, b,
    ln_s, ln_b; ``heads`` acc_w, acc_b, cost_w, cost_b), f32, drawn on the
    CPU from the configuration's router seed and moved to ``device``. The
    accuracy head is random; the cost head predicts each model's cost per
    token normalised to the largest (the paper's costs in [0, 1]) with a
    small per-query spread, as a fitted router would."""
    rng = np.random.default_rng(int(r["seed"]))
    costs = np.asarray(costs, np.float64)
    n_models = len(costs)
    dims = [int(r["d_emb"])] + [int(h) for h in r["hidden"]]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    trunk = []
    for din, dout in zip(dims[:-1], dims[1:]):
        trunk.append({"w": t(rng.standard_normal((din, dout)) * din ** -0.5),
                      "b": t(rng.standard_normal(dout) * 0.02),
                      "ln_s": t(1.0 + rng.standard_normal(dout) * 0.1),
                      "ln_b": t(rng.standard_normal(dout) * 0.02)})
    dh = dims[-1]
    heads = {"acc_w": t(rng.standard_normal((dh, n_models)) * dh ** -0.5),
             "acc_b": t(rng.standard_normal(n_models) * 0.1),
             "cost_w": t(rng.standard_normal((dh, n_models))
                         * 0.05 * dh ** -0.5),
             "cost_b": t(costs / costs.max())}
    return {"trunk": trunk, "heads": heads}
