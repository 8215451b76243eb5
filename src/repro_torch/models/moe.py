"""Mixture-of-Experts layer with top-k token-choice routing (PyTorch
counterpart of ``repro/models/moe.py``).

Two dispatch implementations (selected by ``mode``), as in the reference:

  * ``dense``    — computes every expert for every token and weights each
                   by the top-k gate. Exact (no token dropping); every
                   serving path runs it, so a token's output does not
                   depend on the other tokens of its batch.
  * ``capacity`` — Switch/GShard-style: tokens are sorted by expert id
                   (stable) and scattered into an (E, C, d) buffer with
                   C = max(1, int(T·top_k·cf) // E); experts run as batched
                   matmuls; outputs are gathered back and combined with the
                   gate weights. Tokens past an expert's capacity are
                   dropped.

Neither has a Pallas kernel in the reference, so both are plain PyTorch.
The router's load-balance auxiliary loss (Switch eq. 4) is returned beside
the output.

**Expert parallelism** (``_capacity_shard_map``): under
``sharding.use_rules(mesh, rules)`` with a ``"tokens"`` and an
``"experts"`` rule, ``mode="capacity"`` runs the reference's shard_map
dispatch over ``torch.distributed``, one process per device: each process
takes its block of tokens and its E/n experts, runs the capacity dispatch
locally (C = max(1, int(T_loc·k·cf) // E), the local expert count as the
drop bucket), sums the outputs over the experts axis (an all-reduce) and
all-gathers the token blocks, so every process returns the whole (T, d).
The aux loss averages counts and importance over the tokens axis before
their product, as the reference's ``pmean`` does. Without an experts axis,
or when it does not divide E, the single-block dispatch runs, as in the
reference. The weights are whole in every process (the port's parameters
are plain tensors, made the same in every process by
``sharding.replicate``) and each process slices its experts' block, a
view: the reference's FSDP all-gather over "data" brings back, inside the
block, exactly those whole expert weights from their d-sharded pieces, so
the products are the same; holding the whole weights trades that
collective for memory.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.config import ModelConfig
from repro_torch.kernels.costs import kernel as counted
from repro_torch.kernels.costs import measure
from repro_torch.models import layers as L

#: tokens per dense-dispatch slice: the (E, T, f) and (E, T, d)
#: intermediates of one slice stay under ~0.6 GB at kimi-k2's width
#: (E 384, d 7168, f 2048, bf16). Tokens are independent, so slicing
#: changes no token's result.
_DENSE_TOKENS = 64


def _normal_experts(gen: torch.Generator, shape, scale: float, dtype):
    """``L.normal`` of an (E, ...) expert weight, drawn one expert at a
    time, so the f32 draw never holds more than one expert (on the meta
    device, which holds nothing, all at once)."""
    if gen.device.type == "meta":
        return L.normal(gen, shape, scale, dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        out[e] = L.normal(gen, shape[1:], scale, dtype)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.num_experts
    dt = L.dtype_of(cfg)
    s_in, s_out = d ** -0.5, f ** -0.5
    return {
        "router": L.normal(gen, (d, E), s_in, torch.float32),
        "wg": _normal_experts(gen, (E, d, f), s_in, dt),
        "wu": _normal_experts(gen, (E, d, f), s_in, dt),
        "wd": _normal_experts(gen, (E, f, d), s_out, dt),
    }


def _router_probs(p, x, cfg: ModelConfig):
    """x: (T, d) → top-k (weights (T, k), ids (T, k)), full probs (T, E).
    The logits are f32. Ties go to the lower expert id, as
    ``jax.lax.top_k`` orders them: a stable descending sort, sliced."""
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    top_w, top_ids = top_w[:, :k], top_ids[:, :k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    return top_w, top_ids, probs


def _aux_loss(probs, top_ids, cfg: ModelConfig):
    E = cfg.moe.num_experts
    T = top_ids.shape[0]
    # fraction of tokens dispatched to each expert (first choice proxy):
    # exact counts over T, as the mean of the one-hot rows; scattered,
    # since F.one_hot runs other ops on each device
    first = top_ids[:, 0]
    counts = torch.zeros(E, device=first.device).scatter_add_(
        0, first, torch.ones(T, device=first.device)) / T
    imp = torch.mean(probs, dim=0)
    return E * torch.sum(counts * imp)


def moe_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str = "dense", capacity_factor: float = 1.25) -> tuple:
    """x: (B, S, d) → (out (B, S, d), aux_loss scalar). Under active
    logical-axis rules ``mode="capacity"`` runs the expert-parallel
    dispatch (``_capacity_shard_map``)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    if mode == "capacity" and shd.active():
        out, aux = _capacity_shard_map(p, xt, cfg, capacity_factor)
        return out.reshape(B, S, d).to(x.dtype), aux * cfg.moe.aux_coef
    top_w, top_ids, probs = _router_probs(p, xt, cfg)
    aux = _aux_loss(probs, top_ids, cfg) * cfg.moe.aux_coef
    if mode == "dense":
        out = _dense_dispatch(p, xt, top_w, top_ids, cfg)
    elif mode == "capacity":
        out = _capacity_dispatch(p, xt, top_w, top_ids, cfg, capacity_factor)
    else:
        raise ValueError(f"unknown moe mode {mode!r}")
    return out.reshape(B, S, d).to(x.dtype), aux


def _expert_mlp(p, xe):
    """xe: (E, C, d) → (E, C, d); batched SwiGLU over the expert dim."""
    g = F.silu(torch.bmm(xe, p["wg"]))
    u = torch.bmm(xe, p["wu"])
    return torch.bmm(g * u, p["wd"])


def _slices(T: int) -> list:
    """(first token, length) of each dense-dispatch slice over T tokens."""
    return [(t0, min(_DENSE_TOKENS, T - t0))
            for t0 in range(0, T, _DENSE_TOKENS)]


def _slice_forward(xs, gs, wg, wu, wd, out_rows) -> tuple:
    """One slice of the dense dispatch: every expert on the tokens xs
    (t, d), weighted by their gate rows gs (t, E) f32 cast to the experts'
    dtype, written into ``out_rows`` (t, d). Returns what the slice's
    gradient needs: the gate and up projections and the experts' outputs
    (each (E, t, ·)); g·u is formed in the model dtype, as the reference
    does."""
    E = wg.shape[0]
    xe = xs.unsqueeze(0).expand(E, -1, -1)
    a = torch.bmm(xe, wg)
    u = torch.bmm(xe, wu)
    y = torch.bmm(F.silu(a) * u, wd)                          # (E, t, d)
    out_rows.copy_(torch.einsum("etd,te->td", y, gs.to(y.dtype)))
    return a, u, y


def _grad_buffers(xt, gate, ws) -> tuple:
    """(dx, dgate, [dwg, dwu, dwd]): the slices write dx and dgate and
    add into the zeroed weight gradients."""
    return (torch.empty_like(xt), torch.empty_like(gate),
            [torch.zeros_like(w) for w in ws])


def _slice_backward(go, xs, gs, ws, a, u, y, dx_rows, dg_rows, dws) -> None:
    """The gradient of ``_slice_forward`` for the output rows' gradient
    go (t, d): autograd's products, written into this slice's rows of dx
    and dgate and added into the weight gradients."""
    wg, wu, wd = ws
    E = wg.shape[0]
    gc = gs.to(y.dtype)
    dy = torch.einsum("td,te->etd", go, gc)
    dg_rows.copy_(torch.einsum("etd,td->te", y, go))
    ga = F.silu(a)
    dh = torch.bmm(dy, wd.transpose(1, 2))                    # (E, t, f)
    dws[2].add_(torch.bmm((ga * u).transpose(1, 2), dy))
    da = torch.ops.aten.silu_backward(dh * u, a)
    du = dh * ga
    xe_t = xs.unsqueeze(0).expand(E, -1, -1).transpose(1, 2)
    dws[0].add_(torch.bmm(xe_t, da))
    dws[1].add_(torch.bmm(xe_t, du))
    dx_rows.copy_((torch.bmm(da, wg.transpose(1, 2))
                   + torch.bmm(du, wu.transpose(1, 2))).sum(0))


def _meta(t) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _rows(n: int, like) -> torch.Tensor:
    return torch.empty((n,) + tuple(like.shape[1:]), dtype=like.dtype,
                       device="meta")


def _forward_work(xt, gate, ws, out) -> tuple:
    """(FLOPs, bytes) of the dense dispatch's forward over every slice:
    each distinct slice length counted once on meta tensors, times the
    slices of that length (slices of one length run the same ops)."""
    flops = nbytes = 0
    for t, k in Counter(t for _, t in _slices(xt.shape[0])).items():
        f, b = measure(_slice_forward, _rows(t, xt), _rows(t, gate),
                       *map(_meta, ws), _rows(t, out))
        flops, nbytes = flops + k * f, nbytes + k * b
    return flops, nbytes


def _backward_work(go, xt, gate, ws) -> tuple:
    """(FLOPs, bytes) of the dense dispatch's gradient, as
    ``_forward_work``: the buffers once, each slice length once on meta
    tensors times its slices."""
    mws = [_meta(w) for w in ws]
    flops, nbytes = measure(_grad_buffers, _meta(xt), _meta(gate), mws)
    for t, k in Counter(t for _, t in _slices(xt.shape[0])).items():
        E = ws[0].shape[0]
        act = lambda w: torch.empty((E, t, w.shape[2]), dtype=w.dtype,
                                    device="meta")
        f, b = measure(_slice_backward, _rows(t, go), _rows(t, xt),
                       _rows(t, gate), mws, act(ws[0]), act(ws[1]),
                       act(ws[2]), _rows(t, xt), _rows(t, gate),
                       [torch.empty_like(w) for w in mws])
        flops, nbytes = flops + k * f, nbytes + k * b
    return flops, nbytes


class _DenseExperts(torch.autograd.Function):
    """The dense dispatch's expert work, in slices of ``_DENSE_TOKENS``
    tokens on every device that holds values, with its gradient written
    out slice by slice from what each slice kept (its gate and up
    projections and its experts' outputs). Under ``kernels.costs.OpCosts`` the forward and
    the gradient each record the work of that slicing (``_forward_work``,
    ``_backward_work``: every slice's ops, counted once per slice length
    and scaled), so a step counts the card's work on the meta device too,
    where nothing is computed and no values exist."""

    @staticmethod
    def forward(ctx, xt, gate, wg, wu, wd, keep: bool):
        ws = (wg, wu, wd)
        out = torch.empty(xt.shape, dtype=wd.dtype, device=xt.device)
        saved = []
        with counted("moe_dense_dispatch",
                     lambda: _forward_work(xt, gate, ws, out)):
            if xt.device.type != "meta":
                for t0, t in _slices(xt.shape[0]):
                    acts = _slice_forward(xt[t0:t0 + t], gate[t0:t0 + t],
                                          *ws, out[t0:t0 + t])
                    if keep:
                        saved += acts
        if keep:
            ctx.save_for_backward(xt, gate, *ws, *saved)
        return out

    @staticmethod
    def backward(ctx, go):
        # unpacked first: under the train step's remat this recomputes the
        # unit, whose ops count as any forward's
        xt, gate, *rest = ctx.saved_tensors
        ws, acts = rest[:3], rest[3:]
        with counted("moe_dense_dispatch_grad",
                     lambda: _backward_work(go, xt, gate, ws)):
            dx, dgate, dws = _grad_buffers(xt, gate, ws)
            if xt.device.type != "meta":
                # the last slice first, as autograd sums a weight's
                # gradients (the same roundings)
                for i, (t0, t) in reversed(list(enumerate(_slices(
                        xt.shape[0])))):
                    r = slice(t0, t0 + t)
                    _slice_backward(go[r], xt[r], gate[r], ws,
                                    *acts[3 * i:3 * i + 3], dx[r], dgate[r],
                                    dws)
        return (dx, dgate, *dws, None)


def _dense_dispatch(p, xt, top_w, top_ids, cfg: ModelConfig):
    """Every expert on every token, weighted by the gate. As in the
    reference, the gate is cast to the experts' output dtype before the
    last contraction and g·u is formed in the model dtype."""
    E = cfg.moe.num_experts
    T = xt.shape[0]
    # gate (T, E): top-k weights scattered into the full expert dim
    gate = torch.zeros((T, E), dtype=torch.float32, device=xt.device)
    gate.scatter_add_(1, top_ids, top_w)
    ins = (xt, gate, p["wg"], p["wu"], p["wd"])
    # the slices keep their activations only for a gradient
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
    return _DenseExperts.apply(*ins, keep)


def _capacity_shard_map(p, xt, cfg: ModelConfig, cf: float):
    """The expert-parallel capacity dispatch under the active rules (see
    the module doc). xt: (T, d), the same in every process; returns the
    whole (out (T, d), aux loss) in every process."""
    mesh, rules = shd.current()
    tok_ax, exp_ax = rules.get("tokens"), rules.get("experts")
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    n_exp = shd.axis_size(mesh, exp_ax) if exp_ax else 1
    if exp_ax is None or E % n_exp != 0:
        # cannot expert-shard — the single-block path
        top_w, top_ids, probs = _router_probs(p, xt, cfg)
        return (_capacity_dispatch(p, xt, top_w, top_ids, cfg, cf),
                _aux_loss(probs, top_ids, cfg))
    T, d = xt.shape
    n_tok = shd.axis_size(mesh, tok_ax)
    if T % n_tok:
        raise ValueError(f"{T} tokens do not divide the tokens axis "
                         f"{tok_ax} ({n_tok} processes)")
    T_loc, E_loc = T // n_tok, E // n_exp
    t0 = shd.axis_index(mesh, tok_ax) * T_loc
    lo = shd.axis_index(mesh, exp_ax) * E_loc
    x_loc = xt[t0:t0 + T_loc]
    w = {n: p[n][lo:lo + E_loc] for n in ("wg", "wu", "wd")}
    dev = xt.device

    top_w, top_ids, probs = _router_probs(p, x_loc, cfg)
    local = (top_ids >= lo) & (top_ids < lo + E_loc)
    ids_loc = torch.where(local, top_ids - lo,
                          torch.full_like(top_ids, E_loc))  # drop bucket
    w_loc = torch.where(local, top_w, torch.zeros_like(top_w))
    C = max(1, int(T_loc * k * cf) // E)
    flat_e = ids_loc.reshape(-1)
    flat_w = w_loc.reshape(-1)
    flat_t = torch.arange(T_loc, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, sw, stk = flat_e[order], flat_w[order], flat_t[order]
    counts = torch.bincount(flat_e, minlength=E_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T_loc * k, device=dev) - starts[se]
    keep = (pos < C) & (se < E_loc)
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))
    se_c = torch.where(keep, se, torch.zeros_like(se))
    # dropped entries add zeros at slot 0 of expert 0
    buf = torch.zeros((E_loc, C, d), dtype=x_loc.dtype, device=dev)
    buf.index_put_((se_c, pos_c), torch.where(
        keep[:, None], x_loc[stk], torch.zeros((), dtype=x_loc.dtype,
                                               device=dev)), accumulate=True)
    ye = _expert_mlp(w, buf)                              # (E_loc, C, d)
    y_tok = ye[se_c, pos_c] * torch.where(
        keep, sw, torch.zeros_like(sw))[:, None].to(ye.dtype)
    out = torch.zeros_like(x_loc).index_add_(0, stk, y_tok.to(x_loc.dtype))
    out = shd.all_reduce_sum(out, mesh, exp_ax)
    # the aux loss (Switch eq. 4) is bilinear in two means: both are
    # averaged over the token blocks BEFORE the product, as the global term
    first = top_ids[:, 0]
    counts = torch.zeros(E, device=dev).scatter_add_(
        0, first, torch.ones(T_loc, device=dev)) / T_loc
    imp = torch.mean(probs, dim=0)
    if tok_ax:
        counts = shd.all_reduce_sum(counts, mesh, tok_ax) / n_tok
        imp = shd.all_reduce_sum(imp, mesh, tok_ax) / n_tok
    aux = E * torch.sum(counts * imp)
    return shd.all_gather_axis(out, mesh, tok_ax) if tok_ax else out, aux


def _capacity_dispatch(p, xt, top_w, top_ids, cfg: ModelConfig, cf: float):
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    T, d = xt.shape
    C = max(1, int(T * k * cf) // E)
    dev = xt.device

    flat_e = top_ids.reshape(-1)                          # (T*k,)
    flat_w = top_w.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)

    order = torch.argsort(flat_e, stable=True)
    se, sw, stk = flat_e[order], flat_w[order], flat_t[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts             # exclusive cumsum
    pos = torch.arange(T * k, device=dev) - starts[se]    # slot in expert
    keep = pos < C
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))

    # dropped tokens add zeros at slot 0 of their expert
    buf = torch.zeros((E, C, d), dtype=xt.dtype, device=dev)
    buf.index_put_((se, pos_c), torch.where(keep[:, None], xt[stk],
                                            torch.zeros((), dtype=xt.dtype,
                                                        device=dev)),
                   accumulate=True)
    ye = _expert_mlp(p, buf)                              # (E, C, d)
    w = torch.where(keep, sw, torch.zeros_like(sw))[:, None].to(ye.dtype)
    y_tok = ye[se, pos_c] * w
    return torch.zeros((T, d), dtype=ye.dtype, device=dev).index_add_(
        0, stk, y_tok)
