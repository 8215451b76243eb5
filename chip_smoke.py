#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` with ``nvcc``, holds each kernel against
its plain PyTorch version at the serving shapes and times both, then drives
the port's main path — routed serving of qwen2-1.5b and yi-6b at full
published width and depth, random bf16 weights from a seeded generator —
through each path of ``RoutedServer`` (``generate`` on the paged engine,
``submit`` / ``step`` / ``drain``, each lane alone, the uniform slot pool,
the per-call path), with the launch counters reset just before each path
and read just after it. Last it checks that engine tokens equal
per-request tokens on the reduced f32 models.

Output: JSON lines, then the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, a ``kernels`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line; it also refuses to run without CUDA or
outside a checkout. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and op/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

PROMPTS = [
    "translate this sentence to french please",
    "prove that the sum of two even numbers is even",
    "write a short poem about autumn leaves",
    "derive the gradient of the softmax cross entropy loss",
    "summarize the plot of the odyssey in two lines",
    "solve the recurrence t(n) = 2 t(n/2) + n",
    "what is the capital of australia",
    "explain why the sky is blue to a five year old child",
    "list three prime numbers larger than one hundred",
    "hello",
    "compute the determinant of a three by three matrix with entries one to nine",
    "name a famous painting",
]
MAX_NEW = 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str, code: int) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


# ---------------------------------------------------------------------------
# Timing and tolerances
# ---------------------------------------------------------------------------


def median_ms(torch, fn, reps: int = 50, warmup: int = 3) -> float:
    """Median of ``reps`` individually event-timed calls of ``fn``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bf16_ulp(torch, x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    ax = x.abs().float().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


def check_close(torch, got, want, what: str, scale=None) -> tuple:
    """The stated tolerance: f32 |Δ| ≤ 1e-5 + 1e-5·|ref|; bf16 |Δ| ≤ 2 bf16
    ulps of the plain value, plus, for decode attention, (2^-8 + 1e-5)·A
    where ``scale`` is A = Σ p·|v| / Σ p, the attention of the same query
    over |v|. That term bounds the kernel's one freedom against the plain
    version: the online softmax rounds each probability to bf16 against a
    running maximum instead of the row's final one, and two bf16 roundings
    of p differ by at most 2^-8 of p; 1e-5 covers the f32 sums' order.
    Returns (max |Δ|, max |Δ| / tolerance)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    d = (g - w).abs()
    if want.dtype == torch.bfloat16:
        tol = 2 * bf16_ulp(torch, w)
        if scale is not None:
            tol = tol + (2.0 ** -8 + 1e-5) * scale.float()
    else:
        tol = 1e-5 + 1e-5 * w.abs()
    bad = d > tol
    if bad.any():
        i = int(torch.nonzero(bad.reshape(-1))[0])
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements out of tolerance; first: "
            f"kernel {g.reshape(-1)[i].item()!r} plain "
            f"{w.reshape(-1)[i].item()!r} tolerance "
            f"{tol.reshape(-1)[i].item()!r}")
    return float(d.max()), float((d / tol).max())


def bound(bytes_moved: float, ops: float, dtype: str) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Kernel phase: each kernel against its plain version
# ---------------------------------------------------------------------------


def _check_router(torch, ru, args, what: str) -> tuple:
    """The kernel against its plain version on ``args``: best utility to
    the f32 tolerance, choice equal off near-ties (top-2 margin < 1e-5)."""
    h, aw, ab, cw, cb, lam = args
    c_k, b_k = ru.router_utility_cuda(*args)
    c_p, b_p = ru.router_utility_plain(*args)
    torch.cuda.synchronize()
    err = check_close(torch, b_k, b_p, what)
    U = torch.sigmoid(h @ aw + ab) - lam * (h @ cw + cb)
    top2 = U.topk(min(2, U.shape[1]), dim=-1).values
    margin = (top2[:, 0] - top2[:, -1] if U.shape[1] > 1
              else torch.full_like(top2[:, 0], float("inf")))
    neq = (c_k != c_p) & (margin >= 1e-5)
    if neq.any():
        raise AssertionError(f"{what}: argmax differs on {int(neq.sum())} "
                             "rows")
    return err


def kernel_router(torch, ru, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(11)

    def heads(n, M):
        return (torch.randn((n, 512), generator=gen, device=dev),
                torch.randn((512, M), generator=gen, device=dev) * 0.05,
                torch.randn((M,), generator=gen, device=dev) * 0.1,
                torch.randn((512, M), generator=gen, device=dev) * 0.05,
                torch.randn((M,), generator=gen, device=dev) * 0.1)

    errs = []
    # n: the main path's buckets (1 for submit, 4 for the per-call path,
    # 16 for generate's 12 prompts) and whole and many 8-row blocks
    for n in (1, 4, 8, 16, 1024):
        for M in (2, 40):
            t = heads(n, M)
            for lam in (0.0, 0.5, 10.0):
                errs.append(_check_router(
                    torch, ru, (*t, lam),
                    f"router_utility n={n} M={M} lam={lam}"))
    # the timed call: generate's bucket of 16 at M = 2, λ = 2, checked too
    args = (*heads(16, 2), 2.0)
    errs.append(_check_router(torch, ru, args, "router_utility timed args"))
    n, dh, M = 16, 512, 2
    b_ms, by = bound(4 * (n * dh + 2 * dh * M + 2 * M + 2 * n),
                     4 * n * dh * M, "float32")
    return {"name": "router_utility", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/router_utility.cu",
            "replaces": "src/repro/kernels/router_utility.py:32",
            "shape": "h (16, 512) f32, M 2",
            "max_abs_err": max(e for e, _ in errs),
            "err_over_tol": max(r for _, r in errs),
            "ms": median_ms(torch, lambda: ru.router_utility_cuda(*args)),
            "plain_ms": median_ms(torch, lambda: ru.router_utility_plain(*args)),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def _n_valid_cases(torch, B: int, S: int, gen, dev):
    ragged = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    with_zeros = ragged.clone()
    with_zeros[0] = 0
    with_zeros[B // 2] = 0
    return {"zeros+ragged": with_zeros.int(), "ragged": ragged.int(),
            "full": torch.full((B,), S, dtype=torch.int32, device=dev)}


def _attn_cost(q, kv_dtype, nv, Hkv: int, hd: int, extra_bytes: int):
    """Bytes (q, valid K and V rows, out, bounds) and operations of one
    decode-attention call; only the valid positions are read."""
    esz = 2 if kv_dtype == "bfloat16" else 4
    n_pos = int(nv.sum())
    g = q.shape[2]
    by = (2 * q.numel() * q.element_size() + 2 * n_pos * Hkv * hd * esz
          + 4 * nv.numel() + extra_bytes)
    ops = 4 * n_pos * Hkv * g * hd
    return by, ops


def _sdpa_ms(torch, F, q, k, v, nv):
    """One library call computing the same function: SDPA on the gathered
    and head-expanded K/V with a validity mask (timed only)."""
    B, Hkv, g, hd = q.shape
    S = k.shape[2]
    qq = q.reshape(B, Hkv * g, 1, hd).to(k.dtype)
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    mask = (torch.arange(S, device=q.device)[None, :]
            < nv[:, None]).reshape(B, 1, 1, S)
    return median_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask))


def kernel_decode(torch, F, da, dev) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(12)
    errs_c, errs_p = [], []
    B, hd, ps, npg, P = 8, 128, 16, 16, 129

    def check(errs, got, want, scale, nv, what):
        errs.append(check_close(torch, got, want, what, scale))
        if bool((nv == 0).any()) and bool((got[nv == 0] != 0).any()):
            raise AssertionError(f"{what}: n_valid=0 rows not 0")

    for Hkv, g in ((2, 6), (4, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((B, Hkv, g, hd), generator=gen, device=dev).to(dtype)
            for S in (256, 4096):
                k = torch.randn((B, Hkv, S, hd), generator=gen,
                                device=dev).to(dtype)
                v = torch.randn((B, Hkv, S, hd), generator=gen,
                                device=dev).to(dtype)
                for name, nv in _n_valid_cases(torch, B, S, gen, dev).items():
                    got = da.decode_attention_cuda(q, k, v, nv)
                    want = da.decode_attention_plain(q, k, v, nv)
                    scale = da.decode_attention_plain(q.float(), k, v.abs(), nv)
                    torch.cuda.synchronize()
                    check(errs_c, got, want, scale, nv, f"decode_attention "
                          f"Hkv={Hkv} g={g} S={S} {dtype} {name}")
            kp = torch.randn((P, Hkv, ps, hd), generator=gen, device=dev).to(dtype)
            vp = torch.randn((P, Hkv, ps, hd), generator=gen, device=dev).to(dtype)
            for name, nv in _n_valid_cases(torch, B, npg * ps, gen,
                                           dev).items():
                # shuffled distinct pages per row; entries past each row's
                # bound point at the trash page 0
                pt = torch.stack([torch.randperm(P - 1, generator=gen,
                                                 device=dev)[:npg] + 1
                                  for _ in range(B)]).int()
                blk = torch.arange(npg, device=dev)[None, :] * ps
                pt = torch.where(blk < nv[:, None], pt, torch.zeros_like(pt))
                got = da.paged_decode_attention_cuda(q, kp, vp, pt, nv)
                want = da.paged_decode_attention_plain(q, kp, vp, pt, nv)
                scale = da.paged_decode_attention_plain(q.float(), kp,
                                                        vp.abs(), pt, nv)
                torch.cuda.synchronize()
                check(errs_p, got, want, scale, nv, f"paged_decode_attention "
                      f"Hkv={Hkv} g={g} {dtype} {name}")

    # main-path shapes: yi-6b heads (Hkv 4, g 8) in bf16, 8 decode slots,
    # ragged positions below the 256-position region
    Hkv, g, S = 4, 8, 256
    dt = torch.bfloat16
    nv = torch.randint(1, 200, (B,), generator=gen, device=dev).int()
    q = torch.randn((B, Hkv, g, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((B, Hkv, S, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((B, Hkv, S, hd), generator=gen, device=dev).to(dt)
    check(errs_c, da.decode_attention_cuda(q, k, v, nv),
          da.decode_attention_plain(q, k, v, nv),
          da.decode_attention_plain(q.float(), k, v.abs(), nv), nv,
          "decode_attention timed args")
    by, ops = _attn_cost(q, "bfloat16", nv, Hkv, hd, 0)
    b_ms, b_by = bound(by, ops, "bfloat16")
    uniform = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:88",
        "shape": "q (8, 4, 8, 128) bf16, cache S 256, ragged n_valid",
        "max_abs_err": max(e for e, _ in errs_c),
        "err_over_tol": max(r for _, r in errs_c),
        "ms": median_ms(torch, lambda: da.decode_attention_cuda(q, k, v, nv)),
        "plain_ms": median_ms(torch, lambda: da.decode_attention_plain(
            q, k, v, nv)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": _sdpa_ms(torch, F, q, k, v, nv)}
    kp = torch.randn((P, Hkv, ps, hd), generator=gen, device=dev).to(dt)
    vp = torch.randn((P, Hkv, ps, hd), generator=gen, device=dev).to(dt)
    pt = torch.randperm(P - 1, generator=gen, device=dev)[:B * npg].reshape(
        B, npg).int() + 1
    check(errs_p, da.paged_decode_attention_cuda(q, kp, vp, pt, nv),
          da.paged_decode_attention_plain(q, kp, vp, pt, nv),
          da.paged_decode_attention_plain(q.float(), kp, vp.abs(), pt, nv),
          nv, "paged_decode_attention timed args")
    by, ops = _attn_cost(q, "bfloat16", nv, Hkv, hd, 4 * pt.numel())
    b_ms, b_by = bound(by, ops, "bfloat16")
    from repro_torch.kernels.ref import paged_gather_ref
    paged = {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:173",
        "shape": "q (8, 4, 8, 128) bf16, pool (129, 4, 16, 128), 16 pages/row",
        "max_abs_err": max(e for e, _ in errs_p),
        "err_over_tol": max(r for _, r in errs_p),
        "ms": median_ms(torch, lambda: da.paged_decode_attention_cuda(
            q, kp, vp, pt, nv)),
        "plain_ms": median_ms(torch, lambda: da.paged_decode_attention_plain(
            q, kp, vp, pt, nv)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": _sdpa_ms(torch, F, q, paged_gather_ref(kp, pt),
                               paged_gather_ref(vp, pt), nv)}
    return uniform, paged


# ---------------------------------------------------------------------------
# Main path: routed serving at full width
# ---------------------------------------------------------------------------


def check_result(out: dict, pool, n: int) -> int:
    names = [pm.name for pm in pool]
    vocab = {pm.name: pm.cfg.vocab for pm in pool}
    if len(out["results"]) != n or len(out["routing"]) != n:
        raise AssertionError("generate returned the wrong number of results")
    toks = 0
    for r, m in zip(out["results"], out["routing"]):
        if r["model"] != names[m]:
            raise AssertionError(f"served by {r['model']}, routed to {m}")
        t = r["tokens"]
        if len(t) != MAX_NEW or not all(0 <= x < vocab[r["model"]] for x in t):
            raise AssertionError(f"bad tokens from {r['model']}: {t}")
        toks += len(t)
    return toks


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_lane_tokens(done: dict, rids: dict, pool) -> int:
    """Every request in ``rids`` ({rid: lane}) came back with MAX_NEW
    tokens inside its model's vocabulary; returns the token count."""
    for rid, m in rids.items():
        t = done[rid]
        if t.shape != (MAX_NEW,) or t.min() < 0 or t.max() >= pool[m].cfg.vocab:
            raise AssertionError(f"lane {m}: bad tokens {t}")
    return MAX_NEW * len(rids)


def run_path(torch, ops, name: str, fn, owns: dict, others: tuple) -> dict:
    """Drive one path of the main path with every launch count set to 0
    just before it and read just after. ``owns`` maps each kernel the path
    must launch to its expected count (None: any count > 0); kernels in
    ``others`` must not launch. ``fn`` returns the tokens it generated."""
    ops.reset_launch_counts()
    n, dt = timed(torch, fn)
    counts = ops.launch_counts()
    for k, want in owns.items():
        if counts[k] <= 0 or (want is not None and counts[k] != want):
            raise AssertionError(f"{name}: {counts[k]} launches of {k}, "
                                 f"expected {want or '> 0'}")
    for k in others:
        if counts[k] != 0:
            raise AssertionError(f"{name}: launched {k} {counts[k]} times")
    row = {"phase": "serve", "path": name, "tokens": n, "seconds": dt,
           "tok_per_s": n / dt, "launches": counts}
    emit(row)
    return row


def main_path(torch, dev) -> list:
    """Every path of the slice at full width, each with its own launch
    counts. Returns the ``serve`` rows."""
    from repro_torch import routers
    from repro_torch.config import RouterConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import EngineConfig
    from repro_torch.serve.gateway import RoutedServer, make_pool_model

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    pool = [make_pool_model(a, get_config(a), c, gen=gen, device=dev)
            for a, c in (("qwen2-1.5b", 0.05), ("yi-6b", 0.4))]
    router = routers.make("mlp", RouterConfig(num_models=2)).init(gen,
                                                                  device=dev)
    srv = RoutedServer(pool, router, device=dev)
    srv_uniform = RoutedServer(pool, router, device=dev,
                               engine_cfg=EngineConfig(page_size=None))
    torch.cuda.synchronize()
    n_params = [mdl.param_count(pm.params) for pm in pool]
    emit({"phase": "pool", "models": [pm.name for pm in pool],
          "params": n_params, "init_seconds": time.perf_counter() - t0,
          "mem_gib": torch.cuda.memory_allocated(dev) / 2 ** 30})

    # warm-up, untimed and uncounted: first calls of each server and path
    for s_, kw in ((srv, {}), (srv_uniform, {}), (srv, {"engine": False})):
        check_result(s_.generate(PROMPTS[:2], lam=2.0,
                                 max_new_tokens=MAX_NEW, **kw), pool, 2)
    srv.drain([srv.submit(PROMPTS[0], lam=2.0, max_new_tokens=MAX_NEW)])

    UA, PA, RU = "decode_attention", "paged_decode_attention", "router_utility"
    rows = []

    def gen_fn(s_, prompts, lam, **kw):
        def fn():
            out = s_.generate(prompts, lam=lam, max_new_tokens=MAX_NEW, **kw)
            return check_result(out, pool, len(prompts))
        return fn

    # RoutedServer.generate on the paged engine: one routing call each
    for lam in (0.0, 2.0):
        rows.append(run_path(torch, ops, f"generate lam={lam}",
                             gen_fn(srv, PROMPTS, lam), {RU: 1, PA: None},
                             (UA,)))

    # RoutedServer.submit (one routing call per prompt), then step / drain
    subs = [(p, 0.0) for p in PROMPTS[:4]] + [(p, 2.0) for p in PROMPTS[4:8]]
    lanes = [int(srv.route([p], lam)[0]) for p, lam in subs]   # uncounted

    def submit_fn():
        rids = {srv.submit(p, lam=lam, max_new_tokens=MAX_NEW): m
                for (p, lam), m in zip(subs, lanes)}
        done = dict(srv.step())
        done.update(srv.drain(list(rids)))
        return check_lane_tokens(done, rids, pool)

    rows.append(run_path(torch, ops, "submit x8 + step + drain", submit_fn,
                         {RU: len(subs), PA: None}, (UA,)))

    # each lane on its own, whatever a router would pick: both full-width
    # models decode through the paged kernel, once per layer per step
    for m, pm in enumerate(pool):
        def lane_fn(m=m, pm=pm):
            rids = {srv.engine.submit(m, srv._tokenize([p], pm.cfg, None)[0],
                                      MAX_NEW): m for p in PROMPTS[:4]}
            return check_lane_tokens(srv.drain(list(rids)), rids, pool)
        row = run_path(torch, ops, f"lane {pm.name} x4", lane_fn, {PA: None},
                       (UA, RU))
        if row["launches"][PA] % pm.cfg.n_layers:
            raise AssertionError(f"lane {pm.name}: {row['launches'][PA]} "
                                 f"paged launches, not a multiple of "
                                 f"{pm.cfg.n_layers} layers")
        rows.append(row)

    # the uniform slot pool and the per-call path: the contiguous kernel
    rows.append(run_path(torch, ops, "generate lam=2.0 uniform pool",
                         gen_fn(srv_uniform, PROMPTS, 2.0), {RU: 1, UA: None},
                         (PA,)))
    rows.append(run_path(torch, ops, "generate lam=2.0 engine=False",
                         gen_fn(srv, PROMPTS[:4], 2.0, engine=False),
                         {RU: 1, UA: None}, (PA,)))

    # full width, bf16: engine tokens vs per-request tokens (print only —
    # random weights leave near-ties in the argmax)
    eng = srv.generate(PROMPTS, lam=0.0, max_new_tokens=MAX_NEW)
    same = total = 0
    for p, r in zip(PROMPTS, eng["results"]):
        solo = srv.generate([p], lam=0.0, max_new_tokens=MAX_NEW,
                            engine=False)["results"][0]["tokens"]
        same += sum(a == b for a, b in zip(r["tokens"], solo))
        total += MAX_NEW
    emit({"phase": "full_width_engine_vs_solo", "agree": same / total})
    profile_decode(torch, srv, pool)
    return rows


def profile_decode(torch, srv, pool) -> None:
    """Where a decode step's time goes at full width: both lanes hold 8
    requests; one engine step (one 8-token chunk per lane, 16 decode
    steps) is timed bare, then traced with torch.profiler. Reports the
    device's busy time by kernel and its idle share of the bare step."""
    from torch.profiler import ProfilerActivity, profile
    eng = srv.engine
    for m in range(len(pool)):
        for p in PROMPTS[:8]:
            eng.submit(m, srv._tokenize([p], pool[m].cfg, None)[0], 32)
    eng.step()                                  # admission + first chunk
    _, bare = timed(torch, eng.step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, traced = timed(torch, eng.step)
    eng.drain()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(ms for _, ms, _ in kern)

    def group(name):
        if "decode_contig" in name or "decode_paged" in name:
            return "decode attention (CUDA kernels)"
        if any(t in name.lower() for t in ("gemm", "cutlass", "xmma",
                                           "nvjet", "gemv")):
            return "matmul (cuBLAS)"
        return "other (elementwise, norms, copies, indexing)"

    groups = {}
    for name, ms, n in kern:
        g = groups.setdefault(group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    weight_bytes = sum(_nbytes(pm.params) for pm in pool)
    emit({"phase": "profile", "decode_steps": 2 * eng.ecfg.chunk,
          "step_ms_bare": bare * 1e3, "step_ms_traced": traced * 1e3,
          "device_busy_ms": busy,
          "device_idle_share": (1 - busy / (bare * 1e3)) if busy else None,
          "weights_read_bound_ms": eng.ecfg.chunk * weight_bytes
          / HBM_BYTES_PER_S * 1e3,
          "groups": {k: {"ms": v[0], "launches": v[1]}
                     for k, v in groups.items()},
          "top": [{"kernel": n[:90], "ms": ms, "launches": c}
                  for n, ms, c in sorted(kern, key=lambda r: -r[1])[:8]]})


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def reduced_parity(torch, dev) -> None:
    """Reduced f32 models on the card: engine tokens (paged kernel) must
    equal per-request tokens (uniform kernel) exactly."""
    from repro_torch import routers
    from repro_torch.config import RouterConfig
    from repro_torch.configs import get_config
    from repro_torch.serve.gateway import RoutedServer, make_pool_model

    gen = torch.Generator(device=dev).manual_seed(1)
    pool = [make_pool_model(a, get_config(a).reduced(), c, gen=gen, device=dev)
            for a, c in (("qwen2-1.5b", 0.05), ("yi-6b", 0.4))]
    router = routers.make("mlp", RouterConfig(num_models=2)).init(gen,
                                                                  device=dev)
    srv = RoutedServer(pool, router, device=dev)
    for lam in (0.0, 0.5, 2.0):
        eng = srv.generate(PROMPTS, lam=lam, max_new_tokens=MAX_NEW)
        check_result(eng, pool, len(PROMPTS))
        for p, r in zip(PROMPTS, eng["results"]):
            solo = srv.generate([p], lam=lam, max_new_tokens=MAX_NEW,
                                engine=False)["results"][0]
            if solo != r:
                raise AssertionError(f"lam={lam} {p!r}: engine {r} vs "
                                     f"solo {solo}")
    emit({"phase": "reduced_f32_engine_vs_solo", "prompts": len(PROMPTS),
          "lams": [0.0, 0.5, 2.0], "equal": True})


def main() -> None:
    try:
        import torch
        import torch.nn.functional as F
    except ImportError:
        fail("PyTorch is not installed", 2)
    if not torch.cuda.is_available():
        fail("no CUDA device is available; this smoke test runs on the GPU",
             2)
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no "
             "src/repro_torch)", 3)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import router_utility as ru

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 matmuls in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "gpu": smi})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()}})

    t0 = time.perf_counter()
    rows = [kernel_router(torch, ru, dev), *kernel_decode(torch, F, da, dev)]
    emit({"phase": "kernels_vs_plain", "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    paths = main_path(torch, dev)
    emit({"phase": "main_path_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    reduced_parity(torch, dev)
    emit({"phase": "reduced_done", "seconds": time.perf_counter() - t0})

    for r in rows:
        by_path = {p["path"]: p["launches"][r["name"]] for p in paths}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        # the key names of the issue's contract beside the driver's
        r["max_err"] = r["max_abs_err"]
        r["kernel_ms"] = r["ms"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_err",
            "kernel_ms", "err_over_tol", "shape", "launches_by_path")
    print(smi, flush=True)
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
