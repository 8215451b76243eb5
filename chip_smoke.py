#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` with ``nvcc``, holds each kernel against
its plain PyTorch version (at the serving shapes, at the shapes of the
reference's kernel tests and at the router fit's shapes; the decode
kernels also at their chunk edges, hd 64, 80 and 112, every dtype pair,
and paged against contiguous bit for bit; the K-means reduction also
against its segmented emulation, at its segment and tree edges, and two
launches bit for bit), times both and times each kernel in rounds interleaved with the
one PyTorch call that computes its function (with and without host work;
the decode kernels also at the served shapes; the K-means reduction
beside the assignment alone; the router beside a one-launch floor), then
drives the port's main paths, with the launch counters reset just before
each path and read just after it:

* routed serving of qwen2-1.5b and yi-6b at full published width and
  depth, random bf16 weights from a seeded generator, through each path
  of ``RoutedServer`` (``generate`` on the paged engine, ``submit`` /
  ``step`` / ``drain``, each lane alone, the uniform slot pool, the
  per-call path), routed by the MLP router, then by a K-means router,
  then by an MF and an Elo router;
* prefill attention through ``ops.flash_attention`` at the served models'
  attention shapes (yi-6b and qwen2-1.5b after the GQA repeat, S 4096);
* the federated router fit at the paper's router width (d_emb 768, 11
  models, 10 clients, 36,000 synthetic queries, ``FedConfig()``):
  ``fit_federated`` and ``fit_local`` of "mlp", "mf", "kmeans" and "elo",
  each evaluated on the global test split and routed, a repeated K-means
  fit (bit-identical) and a K-means fit on the plain versions; model
  onboarding (3 of the 11 models withheld, then added from a 10%
  calibration subset), client onboarding (7 clients through
  ``client_mask``, then the other 3), personalization on 3 clients and
  secure aggregation; then one FedAvg round and one K-means fit under
  ``torch.profiler``.

While the full-width pool is loaded, the federation side of the online
loop: 64 requests of 4 clients harvested through ``RoutedServer(harvest=
...)`` behind a fitted MLP router (one expiry recorded as a zero score, one
cancel recorded as nothing, the store equal to a host-side copy), the MLP
router refitted from the harvest with the trimmed mean and hot-swapped in
(routing = the refit's own, ``router_utility`` once per route bucket
before and after), a K-means router fitted on the harvest through both
K-means kernels, and failover under a ``FaultPlan`` (a hard-down backend
and a transient one, counts equal to what the plan predicts), then the
``FedLoop`` over that pool (a ``TrafficScenario`` at d_emb 768, syncs
every 8 chunks, hot-swapped under traffic): one loop saves after phase 0
and serves phase 1, a second loop on a fresh server restores the file and
serves the same phase 1, bit for bit the same. After the fit path: the
corruption table (fedavg, trimmed mean and median, clean and under sign
flip, at the §1 width; all four strategies under all four fault classes
at ``bench_resilience``'s own scale, beside ``BENCH_resilience.json``'s
values), full-width fits with per-round cohorts of 5 and 3 clients, and
``run_online_vs_frozen`` at ``BENCH_fedloop.json``'s scale, at the
reference's smoke scale (twice, the same dict) and with a model onboarded
mid-run.

Once the served pool is freed, LM training and its drivers:
``launch.train.train_loop`` on qwen2-1.5b at full width (bf16, 28 layers,
batch 8 × seq 256, 4 steps; a checkpoint saved and restored bit for bit),
the ``train_lm`` twin (the ~100M f32 config, batch 16 × seq 512, lr 1e-3;
its loss must fall) and the ``launch/serve.py`` twin on qwen2-1.5b (batch
4, prompt 32, 16 new tokens through ``decode_attention``). After the
online-vs-frozen run, the RouterBench harness: ``bench_routerbench``'s
full configuration offline (four families) and online ("mf", "elo"),
beside ``BENCH_routerbench.json``; its smoke configuration offline twice
(the same dict; federated AIQ ≥ client-local AIQ for "mf" in every
scenario); and ``offline_routerbench`` on the §1 corpus, whose
adversarial scenario finds donors without a (Q, Q, d) tensor (its peak
memory is printed).

Then the engine under overload and speculative decode: the verify's
attention at the served shapes of qwen2-1.5b, yi-6b and qwen3-8b (the
folded paged launch and the T contiguous launches equal to T one-position
kernel calls bit for bit, each row alone equal to its row in the batch,
both within the decode tolerance of the plain version); at full width,
bf16, initial reservation with half the pages, deadlines, cancels and a
shedding lane quota over both served models (one terminal status per
request, every slot, page and pool tensor back as before), and
speculative decode (``spec_k`` 4) with qwen3-8b drafted by qwen2-1.5b and
the others by themselves, beside the plain engine.

Then, on reduced f32 models: engine tokens equal per-request tokens; the
reference's deadline replay (``benchmarks/perf_suite.py::bench_preempt``'s
traffic, copied here) gives ``BENCH_preempt.json``'s counts in all six
cells, with resumed requests equal to their solo tokens; speculative
tokens equal the plain engine's, and self-drafting accepts every draft.

Last, the MoE, SSM and hybrid models, one full-width load at a time:
phi-3.5-MoE (16 of its 32 layers) on the paged engine and mamba2-370m
(whole) on the per-call path behind one MLP router, phi also per call;
kimi-k2 (1 of its 61 layers; head dim 112, so the decode kernels' padded
build) on both paths; each MoE decode step timed against its weight-read
bound. On reduced f32 jamba, phi-3.5-MoE, kimi-k2, mamba2-370m and
internvl2-2b: engine tokens equal per-request tokens, SSM and hybrid
per-call tokens at prompts of 1–5 tokens equal token-by-token decode; and
hubert's forward is finite.

Step accounting and the clients mesh (slice 12): ``launch/dryrun.py`` on
the meta device for every arch at decode_32k and qwen2-1.5b at all four
input shapes (counts, the ok / skipped / error tally); one decode step of
each served model at 8 slots counted on the card under ``OpCosts``, equal
to its meta count, and the served pair's weight-read term equal to
``profile``'s bound; the counted FLOPs, MFU and bytes of the qwen2-1.5b
step ``lm_train_full_width`` timed; and the §1-width MLP and K-means fits
through ``fit_federated(mesh=client_mesh())`` on a one-process nccl
group, equal to the in-process fits bit for bit, their all-gathers
counted against the analytic bytes.

Output: JSON lines, then the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, a ``kernels`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line; it also refuses to run without CUDA or
outside a checkout. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent



@functools.lru_cache(maxsize=None)
def data_sheet() -> dict:
    """The data-sheet row (dense peaks: op/s by input type under "flops",
    HBM bytes/s) of the card this runs on, from the checkout's
    ``repro_torch.launch.mesh``; raises for a card with no row."""
    import torch
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import device_peaks
    return device_peaks(torch.cuda.get_device_name(0))

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
#: prompts of the print-only engine-vs-solo comparison at full width (cut
#: from all 12: each solo generation is a per-call decode)
SOLO = PROMPTS[:4]


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


#: rounds of ``interleaved_ms``: kernel and library call alternate, so a
#: drift of the card's clocks or of its neighbours hits both alike
ROUNDS = 5


def device_ms(torch, fn, calls: int = 20) -> float:
    """Device time per call of ``fn``, without the host work (argument
    checks, allocation, launch) that ``median_ms`` includes: ``calls``
    calls queued behind a ~10 ms spin kernel, so that the host has issued
    them all before the first runs, then timed back to back by events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def interleaved_ms(torch, kern, lib=None, reps: int = 10) -> dict:
    """``kern`` and ``lib`` timed in ``ROUNDS`` alternating rounds (kernel,
    library, kernel, ...), each round the median of ``reps`` event-timed
    calls. Returns the medians over the rounds (``ms``, ``library_ms``,
    None without a library call), each round's times and the per-round
    kernel/library ratio's median and min–max spread; and each function's
    device time per call (``device_ms``, ``library_device_ms``)."""
    ks, ls = [], []
    for _ in range(ROUNDS):
        ks.append(median_ms(torch, kern, reps=reps, warmup=1))
        if lib is not None:
            ls.append(median_ms(torch, lib, reps=reps, warmup=1))
    out = {"ms": statistics.median(ks), "library_ms": None, "ms_rounds": ks,
           "device_ms": device_ms(torch, kern)}
    if lib is not None:
        out["library_device_ms"] = device_ms(torch, lib)
        ratio = [k / b for k, b in zip(ks, ls)]
        out.update(library_ms=statistics.median(ls), library_rounds=ls,
                   ratio={"median": statistics.median(ratio),
                          "min": min(ratio), "max": max(ratio)})
    return out


def bf16_ulp(torch, x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    ax = x.abs().float().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


def check_close(torch, got, want, what: str, scale=None,
                p_rounded: bool = True) -> tuple:
    """The stated tolerance: f32 |Δ| ≤ 1e-5 + 1e-5·|ref|; bf16 |Δ| ≤ 2 bf16
    ulps of the plain value; plus, for decode attention where the caller
    passes ``scale`` (every dtype pair but f32 q over an f32 cache),
    (2^-8 + 1e-5)·A, where ``scale`` is A = Σ p·|v| / Σ p, the attention of
    the same query over |v|. The 2^-8·A bounds the kernel's one freedom
    against the plain version: it rounds each probability to the bf16 of
    the V cache against its chunk's maximum instead of the row's, and two
    bf16 roundings of p differ by at most 2^-8 of p (over an f32 cache p is
    not rounded: ``p_rounded=False`` drops that part); 1e-5·A covers the
    f32 sums' order, which a bf16 output of a near-cancelling sum does not
    absorb in its 2 ulps. Returns (max |Δ|, max |Δ| / tolerance)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    d = (g - w).abs()
    if want.dtype == torch.bfloat16:
        tol = 2 * bf16_ulp(torch, w)
    else:
        tol = 1e-5 + 1e-5 * w.abs()
    if scale is not None:
        tol = tol + ((2.0 ** -8 if p_rounded else 0.0) + 1e-5) * scale.float()
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
    t_bytes = bytes_moved / data_sheet()["hbm_bytes_per_s"] * 1e3
    t_ops = ops / data_sheet()["flops"][dtype] * 1e3
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


def _router_bound(n: int, dh: int, M: int) -> tuple:
    return bound(4 * (n * dh + 2 * dh * M + 2 * M + 2 * n), 4 * n * dh * M,
                 "float32")


def kernel_router(torch, ru, dev) -> dict:
    """Kernel #1 against its plain version at the features of every family
    that routes through it: the MLP trunk (dh 512), MF's latent factors
    (dh = mf_rank 32) and Elo's anchor similarities (dh = k_global 20)."""
    gen = torch.Generator(device=dev).manual_seed(11)

    def heads(n, M, dh=512):
        return (torch.randn((n, dh), generator=gen, device=dev),
                torch.randn((dh, M), generator=gen, device=dev) * 0.05,
                torch.randn((M,), generator=gen, device=dev) * 0.1,
                torch.randn((dh, M), generator=gen, device=dev) * 0.05,
                torch.randn((M,), generator=gen, device=dev) * 0.1)

    errs = []
    # n: the main path's buckets (1 for submit, 4 for the per-call path,
    # 16 for generate's 12 prompts) and whole and many 8-row blocks; dh:
    # the three families' features and one that takes the scalar loads;
    # M: one model, the served pool, the fit's 11 models, one and two
    # groups of 16 and a wide pool (three groups, the last partial)
    for dh in (512, 32, 20, 77):
        for n in (1, 4, 8, 16, 1024):
            for M in (1, 2, 11, 16, 17, 40):
                t = heads(n, M, dh)
                for lam in (0.0, 0.5, 10.0):
                    errs.append(_check_router(
                        torch, ru, (*t, lam),
                        f"router_utility dh={dh} n={n} M={M} lam={lam}"))
    # timed at generate's bucket of 16, λ = 2, checked too: M 2 at each
    # family's features (the MLP's is the kernels row), M 11 (the fit's
    # route bucket) and M 40; beside the floor of a one-launch call
    times = {}
    for dh, M in ((32, 2), (20, 2), (32, 11), (20, 11), (512, 11),
                  (512, 40)):
        a = (*heads(16, M, dh), 2.0)
        errs.append(_check_router(torch, ru, a, f"router_utility timed dh={dh}"
                                                f" M={M}"))
        b_ms, by = _router_bound(16, dh, M)
        times[f"h (16, {dh}) f32, M {M}"] = {
            "ms": median_ms(torch, lambda: ru.router_utility_cuda(*a)),
            "device_ms": device_ms(torch, lambda: ru.router_utility_cuda(*a)),
            "plain_ms": median_ms(torch, lambda: ru.router_utility_plain(*a)),
            "bound_ms": b_ms, "bound_by": by}
    emit({"phase": "router_utility_times",
          "launch_floor": _launch_floor(torch, dev), "shapes": times})
    args = (*heads(16, 2), 2.0)
    errs.append(_check_router(torch, ru, args, "router_utility timed args"))
    b_ms, by = _router_bound(16, 512, 2)
    t = interleaved_ms(torch, lambda: ru.router_utility_cuda(*args))
    return {"name": "router_utility", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/router_utility.cu",
            "replaces": "src/repro/kernels/router_utility.py:32",
            "shape": "h (16, 512) f32, M 2",
            "max_abs_err": max(e for e, _ in errs),
            "err_over_tol": max(r for _, r in errs),
            "plain_ms": median_ms(torch, lambda: ru.router_utility_plain(*args)),
            "bound_ms": b_ms, "bound_by": by, **t}


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


def _sdpa_call(torch, F, q, k, v, nv):
    """One library call computing the same function: SDPA on the gathered
    and head-expanded K/V with a validity mask (timed only)."""
    B, Hkv, g, hd = q.shape
    S = k.shape[2]
    qq = q.reshape(B, Hkv * g, 1, hd).to(k.dtype)
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    mask = (torch.arange(S, device=q.device)[None, :]
            < nv[:, None]).reshape(B, 1, 1, S)
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)


def _decode_edges(torch, da, dev, check, errs_c, errs_p) -> None:
    """Both decode kernels at the chunk edges (n_valid C−1, C, C+1, 2C+1,
    3C−1, 0, 1 and the capacity, one row each, C the compiled chunk size),
    at hd 64 and 128 and at the padded hd 80 (hubert's) and 112
    (kimi-k2's), g 1, 6 and 8, for all four (q, cache) dtype pairs,
    each against its plain version; and the paged kernel's output equal bit
    for bit to the contiguous kernel's on the same logical contents, with
    NaN in the trash page and past n_valid in a longer contiguous cache
    (so neither is read)."""
    from repro_torch.kernels.ref import paged_gather_ref
    gen = torch.Generator(device=dev).manual_seed(13)
    C = da._bound().chunk
    B, ps, npg = 8, 16, 32
    P, cap = B * npg + 1, ps * npg
    nv = torch.tensor([C - 1, C, C + 1, 2 * C + 1, 3 * C - 1, 0, 1, cap],
                      dtype=torch.int32, device=dev)
    bf, f32 = torch.bfloat16, torch.float32
    blk = torch.arange(npg, device=dev)[None, :] * ps
    nan = float("nan")
    for hd in (64, 80, 112, 128):
        for Hkv, g in ((2, 6), (4, 8), (1, 1)):
            for qd, cd in ((bf, bf), (f32, f32), (f32, bf), (bf, f32)):
                what = f"hd={hd} Hkv={Hkv} g={g} q {qd} cache {cd} edges"
                q = torch.randn((B, Hkv, g, hd), generator=gen,
                                device=dev).to(qd)
                kp, vp = (torch.randn((P, Hkv, ps, hd), generator=gen,
                                      device=dev).to(cd) for _ in range(2))
                pt = torch.randperm(P - 1, generator=gen, device=dev)[
                    :B * npg].reshape(B, npg).int() + 1
                pt = torch.where(blk < nv[:, None], pt, torch.zeros_like(pt))
                k, v = paged_gather_ref(kp, pt), paged_gather_ref(vp, pt)
                want = da.decode_attention_plain(q, k, v, nv)
                scale = (da.decode_attention_plain(q.float(), k, v.abs(), nv)
                         if bf in (qd, cd) else None)
                got_c = da.decode_attention_cuda(q, k, v, nv)
                got_p = da.paged_decode_attention_cuda(q, kp, vp, pt, nv)
                torch.cuda.synchronize()
                check(errs_c, got_c, want, scale, nv,
                      f"decode_attention {what}", cd == bf)
                check(errs_p, got_p, want, scale, nv,
                      f"paged_decode_attention {what}", cd == bf)
                # the same logical contents: NaN past n_valid in a cache
                # longer by 3C, NaN in the trash page
                pos = torch.arange(cap + 3 * C, device=dev)
                past = (pos[None, :] >= nv[:, None]).reshape(B, 1, -1, 1)
                wide = [torch.where(past, nan, torch.nn.functional.pad(
                    t, (0, 0, 0, 3 * C)).float()).to(cd) for t in (k, v)]
                kn, vn = kp.clone(), vp.clone()
                kn[0], vn[0] = nan, nan
                outs = (got_c, da.decode_attention_cuda(q, *wide, nv),
                        da.paged_decode_attention_cuda(q, kn, vn, pt, nv))
                torch.cuda.synchronize()
                if not all(torch.equal(got_p, o) for o in outs):
                    raise AssertionError(f"{what}: paged and contiguous "
                                         "kernels differ in their bits")


def _decode_served(torch, F, da, dev) -> dict:
    """Both decode kernels at the served shapes, checked and timed against
    SDPA: qwen2-1.5b (Hkv 2, g 6, hd 128), yi-6b (Hkv 4, g 8, hd 128) and
    kimi-k2 (Hkv 8, g 8, hd 112), bf16, 8 decode slots at 1–46 valid
    positions (the served prompts of 1–14 words plus the profile's 32
    decode steps), 16 pages of 16 per row (the engine's max_seq 256); the
    contiguous kernel over the same 256 positions."""
    from repro_torch.kernels.ref import paged_gather_ref
    gen = torch.Generator(device=dev).manual_seed(14)
    B, ps, npg = 8, 16, 16
    P = B * npg + 1
    dt = torch.bfloat16
    out = {}
    for model, Hkv, g, hd in (("qwen2-1.5b", 2, 6, 128), ("yi-6b", 4, 8, 128),
                              ("kimi-k2", 8, 8, 112)):
        nv = torch.randint(1, 47, (B,), generator=gen, device=dev).int()
        q = torch.randn((B, Hkv, g, hd), generator=gen, device=dev).to(dt)
        kp, vp = (torch.randn((P, Hkv, ps, hd), generator=gen,
                              device=dev).to(dt) for _ in range(2))
        pt = torch.randperm(P - 1, generator=gen, device=dev)[
            :B * npg].reshape(B, npg).int() + 1
        k, v = paged_gather_ref(kp, pt), paged_gather_ref(vp, pt)
        want = da.decode_attention_plain(q, k, v, nv)
        scale = da.decode_attention_plain(q.float(), k, v.abs(), nv)
        sdpa = _sdpa_call(torch, F, q, k, v, nv)
        for kind, fn in (
                ("paged", lambda: da.paged_decode_attention_cuda(
                    q, kp, vp, pt, nv)),
                ("contiguous", lambda: da.decode_attention_cuda(q, k, v, nv))):
            err = check_close(torch, fn(), want, f"{kind} decode {model} "
                              "served shape", scale)
            extra = 4 * pt.numel() if kind == "paged" else 0
            b_ms, b_by = bound(*_attn_cost(q, "bfloat16", nv, Hkv, hd, extra),
                               "bfloat16")
            t = interleaved_ms(torch, fn, sdpa)
            out[f"{model} {kind}"] = {
                "Hkv": Hkv, "g": g, "hd": hd,
                "err_over_tol": err[1], "n_valid": nv.tolist(),
                "bound_ms": b_ms, "bound_by": b_by,
                **{key: t[key] for key in ("ms", "device_ms", "library_ms",
                                           "library_device_ms", "ratio")}}
    return out


def _launch_floor(torch, dev) -> dict:
    """What a call of one and of two launches costs at least, measured as
    ``device_ms`` measures the kernels: a one-element in-place add, once
    and twice per call."""
    t = torch.zeros(1, device=dev)
    return {"one_launch_device_ms": device_ms(torch, lambda: t.add_(1)),
            "two_launches_device_ms": device_ms(
                torch, lambda: t.add_(1).add_(1))}


def kernel_decode(torch, F, da, dev) -> tuple:
    gen = torch.Generator(device=dev).manual_seed(12)
    errs_c, errs_p = [], []
    B, hd, ps, npg, P = 8, 128, 16, 16, 129

    def check(errs, got, want, scale, nv, what, p_rounded=True):
        errs.append(check_close(torch, got, want, what, scale, p_rounded))
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
                    check(errs_c, got, want,
                          scale if dtype == torch.bfloat16 else None, nv,
                          f"decode_attention "
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
                check(errs_p, got, want,
                      scale if dtype == torch.bfloat16 else None, nv,
                      f"paged_decode_attention "
                      f"Hkv={Hkv} g={g} {dtype} {name}")

    _decode_edges(torch, da, dev, check, errs_c, errs_p)

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
        "plain_ms": median_ms(torch, lambda: da.decode_attention_plain(
            q, k, v, nv)),
        "bound_ms": b_ms, "bound_by": b_by,
        **interleaved_ms(torch, lambda: da.decode_attention_cuda(q, k, v, nv),
                         _sdpa_call(torch, F, q, k, v, nv))}
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
        "plain_ms": median_ms(torch, lambda: da.paged_decode_attention_plain(
            q, kp, vp, pt, nv)),
        "bound_ms": b_ms, "bound_by": b_by,
        **interleaved_ms(torch, lambda: da.paged_decode_attention_cuda(
            q, kp, vp, pt, nv), _sdpa_call(torch, F, q, paged_gather_ref(
                kp, pt), paged_gather_ref(vp, pt), nv))}
    return uniform, paged


def _near_ties(torch, x, c):
    """(P, n) bool for x (G, n, d), c (P, K, d): rows whose plain top-2
    distance gap is below 1e-5 × (|‖μ‖²| + 2|x·μ|) at the plain winner —
    there the kernel's f32 dot products and cuBLAS's may round either way."""
    G, n, d = x.shape
    P, K, _ = c.shape
    cf = c.float().reshape(G, P // G, K, d)
    c2 = (cf * cf).sum(-1)                                   # (G, R, K)
    xc = torch.matmul(x.float()[:, None], cf.transpose(-1, -2))
    dist = c2[..., None, :] - 2.0 * xc                       # (G, R, n, K)
    if K == 1:
        return torch.zeros((P, n), dtype=torch.bool, device=x.device)
    top = dist.topk(2, dim=-1, largest=False)
    win = top.indices[..., :1]
    scale = (c2[..., None, :].expand_as(dist).gather(-1, win)
             + 2.0 * xc.gather(-1, win).abs())[..., 0]
    gap = top.values[..., 1] - top.values[..., 0]
    return (gap < 1e-5 * scale).reshape(P, n)


def _one_hot_sums(torch, A, x, w, K: int) -> tuple:
    """For the assignment A (P, n) of x (G, n, d), w (G, n): the one-hot
    reduction's sums Σ w·x and Σ|w·x| (P, K, d) and counts Σ w (P, K)."""
    G = x.shape[0]
    R = A.shape[0] // G
    oh = torch.nn.functional.one_hot(A.long(), K).float() * (
        w.float().repeat_interleave(R, 0)[..., None])          # (P, n, K)
    xr = x.float().repeat_interleave(R, 0)
    return (oh.transpose(1, 2) @ xr, oh.transpose(1, 2) @ xr.abs(),
            oh.sum(1))


def _sums_close(torch, S, want, scale, what: str) -> tuple:
    """|S − want| ≤ 1e-5 × Σ|w·x| of the cluster; (max |Δ|, max ratio)."""
    ds = (S - want).abs()
    if (ds > 1e-5 * scale).any():
        raise AssertionError(f"{what}: sums off by {float(ds.max())!r} "
                             "beyond 1e-5 of the cluster's sum of |w·x|")
    if not ds.numel():
        return 0.0, 0.0
    return (float(ds.max()),
            float((ds / scale.clamp(min=1e-30)).max() / 1e-5))


def _counts_close(torch, N, cnt, w, what: str) -> None:
    """Counts exact for 0/1 weights, else to 1e-5 relative."""
    if bool(((w == 0) | (w == 1)).all()):
        if not torch.equal(N, cnt):
            raise AssertionError(f"{what}: 0/1 counts not exact")
    elif ((N - cnt).abs() > 1e-5 * cnt).any():
        raise AssertionError(f"{what}: counts off beyond 1e-5")


def _check_kmeans(torch, F, km, x, c, w, what: str, errs: list,
                  emu: list) -> None:
    """Both kernels against the plain versions on x (G, n, d), c (G·R, K,
    d), w (G, n). Assignments: equal to the plain argmin off near-ties
    (``_near_ties``), the assign and reduce kernels equal to each other.
    Sums: |Δ| ≤ 1e-5 × Σ|w·x| of the cluster, against the plain one-hot
    reduction of the kernel's own assignment, and to the same rule against
    the segmented emulation (the kernel's order in plain PyTorch) on that
    assignment. Counts: exact for 0/1 weights, else to 1e-5 relative. Two
    reduce launches: bit-identical. Appends (max |Δ|, max |Δ| / tolerance)
    to ``errs`` and, to ``emu``, the kernel's max |Δ| from the emulation
    and how many of its sums and counts differ from it in any bit."""
    a_k = km.kmeans_assign_cuda(x, c)
    a_p = km.kmeans_assign_plain(x, c)
    r1 = km.kmeans_assign_reduce_cuda(x, c, w)
    r2 = km.kmeans_assign_reduce_cuda(x, c, w)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(r1, r2)):
        raise AssertionError(f"{what}: the reduction is not deterministic")
    A, S, N = r1
    if not torch.equal(a_k, A):
        raise AssertionError(f"{what}: assign and reduce kernels disagree")
    neq = (a_k != a_p) & ~_near_ties(torch, x, c)
    if neq.any():
        raise AssertionError(f"{what}: {int(neq.sum())} rows assigned "
                             "differently off near-ties")
    want, scale, cnt = _one_hot_sums(torch, A, x, w, c.shape[1])
    errs.append(_sums_close(torch, S, want, scale, what))
    _counts_close(torch, N, cnt, w, what)
    _, S_e, N_e = km.kmeans_reduce_segmented_emulation(x, c, w, assign=A)
    _sums_close(torch, S, S_e, scale, f"{what}: kernel against emulation")
    _counts_close(torch, N, N_e, w, f"{what}: kernel against emulation")
    emu.append({
        "shape": what,
        "max_abs_diff": float((S - S_e).abs().max()) if S.numel() else 0.0,
        "sums_differing": int((S != S_e).sum()), "sums": S.numel(),
        "counts_differing": int((N != N_e).sum())})


def _kmeans_cost(x, c, reduce: bool) -> tuple:
    """Bytes (x, cents, w read once; outputs written once) and f32
    operations of one call on x (G, n, d), c (P, K, d)."""
    G, n, d = x.shape
    P, K, _ = c.shape
    esz = x.element_size()
    by = G * n * d * esz + P * K * d * esz + P * n * 4
    ops = 2 * P * n * K * d
    if reduce:
        by += G * n * 4 + P * K * d * 4 + P * K * 4
        ops += 2 * P * n * d
    return by, ops


def _kmeans_times(torch, km, x, c, w) -> dict:
    """Kernel, plain and library times of both functions on one input."""
    G, n, d = x.shape
    P, K, _ = c.shape
    R = P // G
    xr = x.repeat_interleave(R, 0)                 # the library's layout
    wr = w.repeat_interleave(R, 0)
    offs = (torch.arange(P, device=x.device) * K)[:, None]

    def lib_assign():
        return torch.baddbmm((c * c).sum(-1)[:, None, :], xr,
                             c.transpose(1, 2), alpha=-2).argmin(-1)

    def lib_reduce():
        idx = (lib_assign() + offs).reshape(-1)
        sums = torch.zeros((P * K, d), device=x.device).index_add_(
            0, idx, (wr[..., None] * xr).reshape(-1, d))
        cnts = torch.zeros((P * K,), device=x.device).index_add_(
            0, idx, wr.reshape(-1))
        return sums, cnts

    out = {}
    for name, kern, plain, lib, red in (
            ("kmeans_assign", lambda: km.kmeans_assign_cuda(x, c),
             lambda: km.kmeans_assign_plain(x, c), lib_assign, False),
            ("kmeans_assign_reduce",
             lambda: km.kmeans_assign_reduce_cuda(x, c, w),
             lambda: km.kmeans_assign_reduce_plain(x, c, w), lib_reduce,
             True)):
        b_ms, b_by = bound(*_kmeans_cost(x, c, red), "float32")
        out[name] = {**interleaved_ms(torch, kern, lib),
                     "plain_ms": median_ms(torch, plain, reps=20),
                     "bound_ms": b_ms, "bound_by": b_by}
    # the reduction's share of #5, read beside it: the assignment alone,
    # timed again next to #5 in the same way
    red = out["kmeans_assign_reduce"]
    red["assign_device_ms"] = device_ms(
        torch, lambda: km.kmeans_assign_cuda(x, c))
    red["reduce_device_ms"] = device_ms(
        torch, lambda: km.kmeans_assign_reduce_cuda(x, c, w))
    red["reduction_part_device_ms"] = (red["reduce_device_ms"]
                                       - red["assign_device_ms"])
    return out


def kernel_kmeans(torch, F, km, dev, data: dict) -> tuple:
    """Kernels #4 and #5 against their plain versions (and #5 against its
    segmented emulation) on every shape of tests/test_kernels.py, n = 1,
    ragged row counts, the reduction's segment and tree edges and the fit
    path's own shapes (from the fit phase's data); times at the fit path's
    shapes."""
    from repro_torch.core.kmeans import _plusplus_init
    gen = torch.Generator(device=dev).manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    S = km.REDUCE_SEG

    def rnd(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def unif(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    errs, emu = [], []

    def check(x, c, w, what):
        _check_kmeans(torch, F, km, x, c, w, what, errs, emu)

    for n, d, K in ((64, 8, 3), (513, 77, 13), (1000, 128, 20),
                    (256, 768, 15), (37, 33, 40)):          # test_kmeans_assign
        for dt in (f32, bf16):
            check(rnd(1, n, d, dtype=dt), rnd(1, K, d, dtype=dt), unif(1, n),
                  f"kmeans n={n} d={d} K={K} {dt}")
    for n, d, K in ((65, 1000, 7), (33, 1536, 5), (257, 999, 13),
                    (65, 300, 7), (100, 4096, 40), (70, 900, 9),
                    (200, 24, 1000), (300, 24, 2000), (256, 128, 20),
                    (100, 40, 130), (1, 768, 20), (129, 768, 15)):
        check(rnd(1, n, d), rnd(1, K, d), unif(1, n),
              f"kmeans n={n} d={d} K={K}")
    # K 1, and R·K past one 64-centroid group of the assignment kernel
    # (a problem straddles the groups), with d a multiple of 4 and not
    for G, n, d, R, K in ((1, 97, 768, 1, 1), (2, 50, 24, 3, 1),
                          (2, 301, 100, 3, 30), (2, 301, 101, 3, 30),
                          (1, 77, 64, 1, 65)):
        for dt in (f32, bf16):
            check(rnd(G, n, d, dtype=dt), rnd(G * R, K, d, dtype=dt),
                  unif(G, n), f"kmeans G={G} n={n} d={d} R={R} K={K} {dt}")
    x = rnd(1, 513, 77)                                      # 0/1 weights
    check(x, rnd(1, 13, 77), (unif(1, 513) > 0.3).float(),
          "kmeans 0/1 weights")
    x = rnd(1, 37, 9)                                        # zero-weight pad
    w = (torch.arange(37, device=dev) < 30).float()[None]
    check(x, x[:, :5].clone(), w, "kmeans padding")
    a2 = km.kmeans_assign_reduce_cuda(x[0], x[0, :5].clone(), w[0])
    a3 = km.kmeans_assign_reduce_cuda(x, x[:, :5].clone(), w)
    if not all(torch.equal(u, v[0]) for u, v in zip(a2, a3)):
        raise AssertionError("kmeans: 2-D and batched calls differ")

    # the reduction's edges: n at a segment's edges and one past two
    # segments, f32 rows with and without 16-byte loads and bf16 rows,
    # 2 slabs × 3 restarts; one tree stage past 8 segments, two past 64
    for n in (S - 1, S, S + 1, 2 * S + 1, 1):
        for d, dt in ((768, f32), (77, f32), (64, bf16)):
            check(rnd(2, n, d, dtype=dt), rnd(6, 15, d, dtype=dt),
                  unif(2, n), f"kmeans edge n={n} d={d} {dt} G=2 R=3 K=15")
    for n in (8 * S + 1, 64 * S + 1):
        check(rnd(1, n, 20), rnd(3, 7, 20), unif(1, n),
              f"kmeans edge n={n} d=20 R=3 K=7")
    x = rnd(2, 2 * S + 1, 40)
    far = rnd(6, 15, 40) * 100.0
    one = far.clone()
    one[:, 0] = 0.0                        # centroid 0 takes every row
    check(x, one, unif(2, 2 * S + 1), "kmeans one cluster takes every row")
    half = rnd(6, 15, 40)
    half[:, 8:] *= 100.0                   # centroids 8.. far: empty
    check(x, half, (unif(2, 2 * S + 1) > 0.5).float(),
          "kmeans empty clusters, 0/1 weights")
    check(x, half, torch.zeros((2, 2 * S + 1), device=dev),
          "kmeans all weights zero")
    check(x, rnd(6, 30, 40), (unif(2, 2 * S + 1) > 0.3).float(),
          "kmeans R·K = 90, 0/1 weights")
    check(rnd(1, S + 1, 24), rnd(1, 300, 24), unif(1, S + 1),
          "kmeans K 300 > rows")
    for d in (768, 77):                    # n = 0 writes zeros
        _, s0, c0 = km.kmeans_assign_reduce_cuda(
            rnd(2, 0, d), rnd(6, 15, d), unif(2, 0))
        torch.cuda.synchronize()
        if s0.shape != (6, 15, d) or s0.abs().sum() or c0.abs().sum():
            raise AssertionError(f"kmeans n=0 d={d}: not zeros")

    # the fit path's shapes: a local Lloyd step (10 clients × 3 restarts),
    # one client's local fit (3 restarts), the server step (150 uploads, K
    # 20, 3 restarts), the statistics over every client's rows (38,970),
    # predict on the global test set, a route bucket of 16 and routing's
    # 12 prompts
    tr, tg = data["train"], data["test_global"]
    xl, wl = tr["x"], (tr["w"] > 0).float()
    N, D_max, d = xl.shape
    cl = _plusplus_init(gen, xl, wl, 15, 3).reshape(N * 3, 15, d)
    check(xl, cl, wl, "kmeans local Lloyd step")
    x1, c1, w1 = xl[:1], cl[:3].contiguous(), wl[:1]
    check(x1, c1, w1, "kmeans local fit, one client")
    xs = cl[::3].reshape(1, N * 15, d).contiguous()
    ws = torch.randint(0, 400, (1, N * 15), generator=gen, device=dev).float()
    cs = _plusplus_init(gen, xs, ws, 20, 3).reshape(3, 20, d)
    check(xs, cs, ws, "kmeans server step")
    xq = tg["x"][None]
    cq = cs[:1].contiguous()
    check(xq, cq, torch.ones(xq.shape[:2], device=dev), "kmeans predict")
    check(xq[:, :16].contiguous(), cq, torch.ones((1, 16), device=dev),
          "kmeans route bucket")
    check(xq[:, :12].contiguous(), cq, torch.ones((1, 12), device=dev),
          "kmeans routing")
    xt, wt = xl.reshape(1, N * D_max, d), wl.reshape(1, N * D_max)
    check(xt, cq, wt, "kmeans statistics")
    emit({"phase": "kmeans_emulation", "shapes": len(emu),
          "max_abs_diff": max(e["max_abs_diff"] for e in emu),
          "sums_differing": sum(e["sums_differing"] for e in emu),
          "sums": sum(e["sums"] for e in emu),
          "counts_differing": sum(e["counts_differing"] for e in emu),
          "shapes_differing": [e for e in emu if e["sums_differing"]
                               or e["counts_differing"]][:8]})

    t_local = _kmeans_times(torch, km, xl, cl, wl)
    t_pred = _kmeans_times(torch, km, xq, cq, torch.ones(xq.shape[:2],
                                                         device=dev))
    others = {"server step (1, 150, 768), K 20, R 3":
              _kmeans_times(torch, km, xs, cs, ws),
              "route bucket (1, 16, 768), K 20":
              _kmeans_times(torch, km, xq[:, :16].contiguous(), cq,
                            torch.ones((1, 16), device=dev)),
              f"local Lloyd step (10, {D_max}, 768), K 15, R 3": t_local,
              f"local fit (1, {D_max}, 768), K 15, R 3":
              _kmeans_times(torch, km, x1, c1, w1),
              f"statistics (1, {N * D_max}, 768), K 20":
              _kmeans_times(torch, km, xt, cq, wt),
              f"predict (1, {xq.shape[1]}, 768), K 20": t_pred}
    emit({"phase": "kmeans_times", "shapes": others})
    err = max(e for e, _ in errs)
    ratio = max(r for _, r in errs)
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
              "max_abs_err": err, "err_over_tol": ratio}
    assign = {"name": "kmeans_assign",
              "replaces": "src/repro/kernels/kmeans_assign.py:123",
              "shape": f"predict: x (1, {xq.shape[1]}, 768) f32, K 20",
              **common, **t_pred["kmeans_assign"]}
    reduce = {"name": "kmeans_assign_reduce",
              "replaces": "src/repro/kernels/kmeans_assign.py:291",
              "shape": f"Lloyd step: x (10, {D_max}, 768) f32, 30 problems, "
                       "K 15",
              **common, **t_local["kmeans_assign_reduce"]}
    return assign, reduce


#: the served models' prefill attention after the GQA repeat, S 4096
FLASH_SHAPES = {"yi-6b": (1, 4096, 32, 128), "qwen2-1.5b": (1, 4096, 12, 128)}


def _check_flash(torch, fa, q, k, v, causal: bool, what: str) -> tuple:
    """The kernel against its plain version. Both compute in f32 from the
    same inputs and round once to q's dtype; they differ only in the order
    of f32 sums (dot products, the online softmax's rescaling, p·v). The
    tolerance: f32 |Δ| ≤ 2e-5·(|want| + A), bf16 |Δ| ≤ 1 bf16 ulp of want
    + 2e-5·A, where A = Σp|v|/Σp (the same attention over |v|) bounds
    |want| and sets the scale of every term of p·v, 2e-5 is the reference
    test's tolerance taken relative to it, and one ulp covers two f32
    values on either side of a bf16 rounding boundary. Returns (max |Δ|,
    max |Δ| / tolerance)."""
    got = fa.flash_attention_cuda(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    A = fa.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                 causal=causal)
    torch.cuda.synchronize()
    if got.dtype != q.dtype or got.shape != q.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    d = (g - w).abs()
    tol = (bf16_ulp(torch, w) + 2e-5 * A if q.dtype == torch.bfloat16
           else 2e-5 * (w.abs() + A))
    if (d > tol).any():
        i = int(torch.argmax(d / tol))
        raise AssertionError(f"{what}: {int((d > tol).sum())} elements out "
                             f"of tolerance; worst: kernel "
                             f"{g.reshape(-1)[i].item()!r} plain "
                             f"{w.reshape(-1)[i].item()!r} tolerance "
                             f"{tol.reshape(-1)[i].item()!r}")
    return float(d.max()), float((d / tol).max())


def _flash_times(torch, F, fa, q, k, v) -> dict:
    """Kernel, plain and library times, causal, and the bound: q, k, v read
    once and the output written once; 4·B·H·hd·S(S+1)/2 operations (the
    causal half of q·kᵀ and p·v) at the bf16 rate."""
    B, S, H, hd = q.shape
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    b_ms, b_by = bound(4 * q.numel() * q.element_size(),
                       4 * B * H * hd * S * (S + 1) / 2, "bfloat16")
    return {**interleaved_ms(torch, lambda: fa.flash_attention_cuda(q, k, v),
                             lambda: F.scaled_dot_product_attention(
                                 qt, kt, vt, is_causal=True)),
            "plain_ms": median_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v), reps=10),
            "bound_ms": b_ms, "bound_by": b_by}


def kernel_flash(torch, F, fa, dev) -> dict:
    """Kernel #6 against its plain version, f32 (CUDA cores) and bf16
    (tensor cores), causal and not, at the shapes of the reference's test
    (tests/test_kernels.py::test_flash_attention), at the bf16 path's edges
    for hd 64 and 128 (S not a multiple of the 128-row query and key tiles:
    129, 200, 1000, 4095; S = 1; B > 1 with H > 1; a long non-causal case,
    where no tile is skipped) and at the path's own shapes; timed at the
    served models' shapes."""
    gen = torch.Generator(device=dev).manual_seed(14)

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for _ in range(3)]

    errs = []
    for shape in ((1, 128, 2, 64), (2, 256, 4, 64), (2, 512, 2, 128),
                  (1, 200, 3, 128), (2, 1000, 2, 64), (3, 1, 2, 64),
                  (2, 129, 3, 64), (2, 129, 3, 128), (1, 1000, 2, 128),
                  (1, 4095, 2, 64), (1, 4095, 2, 128), (2, 1, 3, 128),
                  (1, 2048, 8, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(shape, dtype)
            for causal in (True, False):
                errs.append(_check_flash(torch, fa, q, k, v, causal,
                                         f"flash {shape} {dtype} "
                                         f"causal={causal}"))
    times = {}
    for name, shape in FLASH_SHAPES.items():
        q, k, v = qkv(shape, torch.bfloat16)
        errs.append(_check_flash(torch, fa, q, k, v, True,
                                 f"flash {name} {shape}"))
        times[name] = _flash_times(torch, F, fa, q, k, v)
    emit({"phase": "flash_times", "shapes": {
        f"{n}: q {FLASH_SHAPES[n]} bf16 causal": t for n, t in times.items()}})
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:68",
            "shape": f"yi-6b prefill: q {FLASH_SHAPES['yi-6b']} bf16 causal",
            "max_abs_err": max(e for e, _ in errs),
            "err_over_tol": max(r for _, r in errs), **times["yi-6b"]}


def flash_path(torch, dev) -> dict:
    """Prefill attention through the port's entry point
    (``ops.flash_attention``) at the served models' shapes, causal bf16:
    one kernel launch per call."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(15)
    inputs = [[torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3)] for shape in FLASH_SHAPES.values()]

    def fn():
        for q, k, v in inputs:
            out = ops.flash_attention(q, k, v, causal=True)
            if out.shape != q.shape or not torch.isfinite(out.float()).all():
                raise AssertionError("flash_attention: bad output")

    ops.flash_attention(*inputs[0], causal=True)            # warm-up
    _, row = run_fit(torch, ops, "flash_attention", fn,
                     {"flash_attention": len(inputs)}, phase="flash")
    return row


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


def main_path(torch, dev) -> tuple:
    """Every path of the slice at full width, each with its own launch
    counts. Returns the ``serve`` rows, the pool and the ``profile`` row."""
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
    KA, KR, FA = "kmeans_assign", "kmeans_assign_reduce", "flash_attention"
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
                             (UA, KA, KR, FA)))

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
                         {RU: len(subs), PA: None}, (UA, KA, KR, FA)))

    # each lane on its own, whatever a router would pick: both full-width
    # models decode through the paged kernel, once per layer per step
    for m, pm in enumerate(pool):
        def lane_fn(m=m, pm=pm):
            rids = {srv.engine.submit(m, srv._tokenize([p], pm.cfg, None)[0],
                                      MAX_NEW): m for p in PROMPTS[:4]}
            return check_lane_tokens(srv.drain(list(rids)), rids, pool)
        row = run_path(torch, ops, f"lane {pm.name} x4", lane_fn, {PA: None},
                       (UA, RU, KA, KR, FA))
        if row["launches"][PA] % pm.cfg.n_layers:
            raise AssertionError(f"lane {pm.name}: {row['launches'][PA]} "
                                 f"paged launches, not a multiple of "
                                 f"{pm.cfg.n_layers} layers")
        rows.append(row)

    # the uniform slot pool and the per-call path: the contiguous kernel
    rows.append(run_path(torch, ops, "generate lam=2.0 uniform pool",
                         gen_fn(srv_uniform, PROMPTS, 2.0), {RU: 1, UA: None},
                         (PA, KA, KR, FA)))
    rows.append(run_path(torch, ops, "generate lam=2.0 engine=False",
                         gen_fn(srv, PROMPTS[:4], 2.0, engine=False),
                         {RU: 1, UA: None}, (PA, KA, KR, FA)))

    # the K-means, MF and Elo routers (num_models=2, d_emb 768) in front of
    # the same pool: K-means routes by the kmeans_assign kernel and a
    # gather; MF and Elo by router_utility on their latent factors (dh 32)
    # and anchor similarities (dh 20)
    for fam, owns, others in (("kmeans", {KA: 1}, (UA, RU, KR, FA)),
                              ("mf", {RU: 1}, (UA, KA, KR, FA)),
                              ("elo", {RU: 1}, (UA, KA, KR, FA))):
        srv_f = RoutedServer(pool, pool_router(torch, dev, fam), device=dev)
        check_result(srv_f.generate(PROMPTS[:2], lam=2.0,
                                    max_new_tokens=MAX_NEW), pool, 2)  # warm-up
        for lam in (0.0, 2.0):
            rows.append(run_path(torch, ops,
                                 f"generate lam={lam} {fam} router",
                                 gen_fn(srv_f, PROMPTS, lam),
                                 {**owns, PA: None}, others))

    # full width, bf16: engine tokens vs per-request tokens (print only —
    # random weights leave near-ties in the argmax)
    eng = srv.generate(SOLO, lam=0.0, max_new_tokens=MAX_NEW)
    same = total = 0
    for p, r in zip(SOLO, eng["results"]):
        solo = srv.generate([p], lam=0.0, max_new_tokens=MAX_NEW,
                            engine=False)["results"][0]["tokens"]
        same += sum(a == b for a, b in zip(r["tokens"], solo))
        total += MAX_NEW
    emit({"phase": "full_width_engine_vs_solo", "prompts": len(SOLO),
          "agree": same / total})
    return rows, pool, profile_decode(torch, srv, pool)


def _traced_step(torch, srv, lanes) -> tuple:
    """Fill each lane in ``lanes`` with 8 requests (PROMPTS[:8], 32 new
    tokens), admit them and decode a first chunk, then time one engine
    step bare and one under torch.profiler, and drain. Returns (bare
    seconds, traced seconds, [(kernel, device ms, launches)])."""
    from torch.profiler import ProfilerActivity, profile
    eng = srv.engine
    for m in lanes:
        for p in PROMPTS[:8]:
            eng.submit(m, srv._tokenize([p], srv.pool[m].cfg, None)[0], 32)
    eng.step()                                  # admission + first chunk
    _, bare = timed(torch, eng.step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, traced = timed(torch, eng.step)
    eng.drain()
    cuda = torch.autograd.DeviceType.CUDA
    return bare, traced, [(e.key, e.self_device_time_total / 1e3, e.count)
                          for e in prof.key_averages()
                          if e.device_type == cuda]


def profile_decode(torch, srv, pool) -> dict:
    """Where a decode step's time goes at full width: both lanes hold 8
    requests; one engine step (one 8-token chunk per lane, 16 decode
    steps) is timed bare, then traced with torch.profiler. Reports the
    device's busy time by kernel and its idle share of the bare step.
    Returns the printed row."""
    eng = srv.engine
    bare, traced, kern = _traced_step(torch, srv, range(len(pool)))
    busy = sum(ms for _, ms, _ in kern)

    def group(name):
        if any(t in name for t in ("decode_contig", "decode_paged",
                                   "decode_merge")):
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
    row = {"phase": "profile", "decode_steps": 2 * eng.ecfg.chunk,
           "step_ms_bare": bare * 1e3, "step_ms_traced": traced * 1e3,
           "device_busy_ms": busy,
           "device_idle_share": (1 - busy / (bare * 1e3)) if busy else None,
           "weights_read_bound_ms": eng.ecfg.chunk * weight_bytes
           / data_sheet()["hbm_bytes_per_s"] * 1e3,
           "groups": {k: {"ms": v[0], "launches": v[1]}
                      for k, v in groups.items()},
           "top": [{"kernel": n[:90], "ms": ms, "launches": c}
                   for n, ms, c in sorted(kern, key=lambda r: -r[1])[:8]]}
    emit(row)
    return row


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------------------
# Fit path: the federated router fit at the paper's router width
# ---------------------------------------------------------------------------

N_QUERIES = 36_000      # RouterBench's grid: 8 datasets × 11 models


def fit_data(torch, dev) -> dict:
    """The synthetic corpus (36,000 queries × 8 tasks × 11 models, d_emb
    768) and its federated split under ``FedConfig()``, drawn on the card
    from a seeded generator: returns (corpus, split)."""
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.data.partition import federated_split
    from repro_torch.data.synthetic import make_eval_corpus
    rcfg = RouterConfig()
    gen = torch.Generator(device=dev).manual_seed(20)
    t0 = time.perf_counter()
    corpus = make_eval_corpus(gen, n_queries=N_QUERIES, n_tasks=8,
                              n_models=rcfg.num_models, d_emb=rcfg.d_emb)
    split = federated_split(gen, corpus, FedConfig())
    torch.cuda.synchronize()
    tr = split["train"]
    emit({"phase": "fit_data", "seconds": time.perf_counter() - t0,
          "train": list(tr["x"].shape),
          "client_rows": tr["w"].sum(1).int().tolist(),
          "test_rows": int(split["test_global"]["x"].shape[0]),
          "train_mib": sum(v.numel() * v.element_size()
                           for v in tr.values()) / 2 ** 20})
    return corpus, split


def pool_router(torch, dev, family: str):
    """A router of ``family`` over the two pool models (num_models=2, d_emb
    768), fitted with ``fit_federated`` on a 4,000-query corpus of two
    models: once per family, each caller getting a copy of its state."""
    from repro_torch.train.optim import tree_map
    router = _pool_router(torch, dev, family)
    return router.with_state(tree_map(lambda t: t.clone(), router.state))


@functools.lru_cache(maxsize=None)
def _pool_router(torch, dev, family: str):
    from repro_torch import routers
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.data.partition import federated_split
    from repro_torch.data.synthetic import make_eval_corpus
    rcfg = RouterConfig(num_models=2)
    gen = torch.Generator(device=dev).manual_seed(21)
    corpus = make_eval_corpus(gen, n_queries=4000, n_tasks=8, n_models=2,
                              d_emb=rcfg.d_emb)
    split = federated_split(gen, corpus, FedConfig())
    router, _ = routers.fit_federated(routers.make(family, rcfg),
                                      split["train"], FedConfig(), gen=gen,
                                      device=dev)
    return router


def run_fit(torch, ops, name: str, fn, owns: dict, extra=None,
            phase: str = "fit") -> tuple:
    """One run of the fit path with every launch count set to 0 just before
    it and read just after. ``owns`` maps each kernel the run must launch
    to its expected count (None: any count > 0); every other kernel must
    not launch. Returns (fn's result, the row)."""
    ops.reset_launch_counts()
    out, dt = timed(torch, fn)
    counts = ops.launch_counts()
    for k, n in counts.items():
        want = owns.get(k, 0)
        if (k in owns and n <= 0) or (want is not None and n != want):
            raise AssertionError(f"{name}: {n} launches of {k}, expected "
                                 f"{'> 0' if want is None else want}")
    row = {"phase": phase, "path": name, "seconds": dt, "launches": counts,
           **(extra(out) if extra else {})}
    emit(row)
    return out, row


def auc_bounds(torch, tg, models=None) -> tuple:
    """(the cheapest model's accuracy, the oracle's frontier AUC) on the
    test split ``tg``, over ``models`` (default: all) — the band every
    fitted router's AUC must lie in."""
    from repro_torch.core import policy
    acc, cost = tg["acc_table"], tg["cost_table"]
    if models is not None:
        acc, cost = acc[:, models], cost[:, models]
    oracle = policy.eval_router(lambda x: (acc, cost), tg["x"], acc, cost)[2]
    return float(acc[:, int(torch.argmin(cost.mean(0)))].mean()), oracle


def check_auc(name: str, auc: float, band: tuple) -> None:
    """``auc`` within ``band`` up to 1e-6 (a router that sends everything
    to the cheapest model scores its accuracy, averaged in another f32
    order)."""
    if not (math.isfinite(auc) and band[0] - 1e-6 <= auc <= band[1] + 1e-6):
        raise AssertionError(f"{name}: AUC {auc!r} outside {band!r}")


def fit_phase(torch, dev, split) -> tuple:
    """``fit_federated`` of "mlp" and "mf" (30 rounds), "kmeans" and "elo"
    (one-shot), ``fit_local`` of each on 3 clients (MLP and MF 300 steps),
    ``eval_router`` on the global test split and a route bucket, each a run
    with its own launch counts. Checks every AUC lies between the cheapest
    model's accuracy and the oracle's AUC, a repeated K-means fit is
    bit-identical, and the K-means fit with the plain versions agrees with
    the kernels' fit. Returns (rows, {fit name: router})."""
    import os

    from repro_torch import routers
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.core import policy
    from repro_torch.data.partition import client_slice
    from repro_torch.kernels import ops
    rcfg, fcfg = RouterConfig(), FedConfig()
    KA, KR, RU = "kmeans_assign", "kmeans_assign_reduce", "router_utility"
    train, tg = split["train"], split["test_global"]
    rows, aucs, fitted = [], {}, {}

    def auc_of(r):
        return policy.eval_router(r.predict, tg["x"], tg["acc_table"],
                                  tg["cost_table"])[2]

    floor, oracle = band = auc_bounds(torch, tg)

    def fit(name, family, federated, owns, seed, client=None, **kw):
        gen = torch.Generator(device=dev).manual_seed(seed)
        if federated:
            fn = lambda: routers.fit_federated(routers.make(family, rcfg),
                                               train, fcfg, gen=gen,
                                               device=dev, **kw)
        else:
            fn = lambda: routers.fit_local(routers.make(family, rcfg),
                                           client_slice(train, client),
                                           fcfg, gen=gen, device=dev, **kw)
        loss = lambda out: ({"loss_round1": out[1]["loss"][0],
                             "loss_round30": out[1]["loss"][-1]}
                            if federated and out[1]["loss"] else {})
        (router, _), row = run_fit(torch, ops, name, fn, owns, loss)
        rows.append(row)
        auc, row = run_fit(torch, ops, f"{name}: eval_router (predict)",
                           lambda: auc_of(router),
                           {KA: 1} if family == "kmeans" else {},
                           lambda a: {"auc": a})
        rows.append(row)
        _, row = run_fit(torch, ops, f"{name}: route bucket of 16",
                         lambda: router.route(tg["x"][:16], 1.0),
                         {KA: 1} if family == "kmeans" else {RU: 1})
        rows.append(row)
        check_auc(name, auc, band)
        aucs.setdefault(name.split(" client")[0], []).append(auc)
        fitted[name] = router
        return router

    iters = rcfg.kmeans_iters
    fit("fed mlp", "mlp", True, {}, 30)
    fit("fed mf", "mf", True, {}, 32)
    # one launch per Lloyd step for all 10 clients × 3 restarts, then the
    # server's; kmeans_assign: the two final assignments and the statistics
    km = fit("fed kmeans", "kmeans", True, {KR: 2 * iters, KA: 3}, 31)
    # Elo: the same anchors; its statistics are soft, so no third assign
    fit("fed elo", "elo", True, {KR: 2 * iters, KA: 2}, 33)
    for i in range(3):
        fit(f"local mlp client {i}", "mlp", False, {}, 40 + i, client=i,
            steps=300)
        fit(f"local mf client {i}", "mf", False, {}, 44 + i, client=i,
            steps=300)
        fit(f"local kmeans client {i}", "kmeans", False, {KR: iters, KA: 2},
            50 + i, client=i)
        fit(f"local elo client {i}", "elo", False, {KR: iters, KA: 1},
            54 + i, client=i)

    def refit():
        gen = torch.Generator(device=dev).manual_seed(31)
        return routers.fit_federated(routers.make("kmeans", rcfg), train,
                                     fcfg, gen=gen, device=dev)[0]

    (again, _), row = run_fit(torch, ops, "fed kmeans repeated", lambda: (
        refit(), None), {KR: 2 * iters, KA: 3})
    rows.append(row)
    same = all(torch.equal(km.state[k], again.state[k]) for k in km.state)
    if not same:
        raise AssertionError("fed kmeans: a repeated fit with one seed gave "
                             "other centroids or statistics")
    os.environ["REPRO_TORCH_KERNELS"] = "ref"
    try:
        (plain, _), row = run_fit(torch, ops, "fed kmeans impl=ref",
                                  lambda: (refit(), None), {})
    finally:
        del os.environ["REPRO_TORCH_KERNELS"]
    rows.append(row)
    # the two fits' test-set assignments: equal off near-ties of the plain
    # fit's centroids; AUCs within 0.01
    c_k, c_p = km.state["centroids"], plain.state["centroids"]
    a_k = ops.kmeans_assign(tg["x"], c_k, impl="ref")
    a_p = ops.kmeans_assign(tg["x"], c_p, impl="ref")
    d_p = (c_p * c_p).sum(-1)[None] - 2.0 * tg["x"] @ c_p.T
    gap = d_p.gather(1, a_k[:, None].long()) - d_p.gather(1, a_p[:, None].long())
    scale = (c_p * c_p).sum(-1)[a_p.long()] + 2.0 * (
        tg["x"] * c_p[a_p.long()]).sum(-1).abs()
    off = (a_k != a_p) & (gap[:, 0] >= 1e-5 * scale)
    auc_p = auc_of(plain)
    emit({"phase": "fit_kernels_vs_plain", "centroid_max_abs_diff":
          float((c_k - c_p).abs().max()), "rows_differing":
          int((a_k != a_p).sum()), "rows_differing_off_near_ties":
          int(off.sum()), "auc_kernels": aucs["fed kmeans"][0],
          "auc_plain": auc_p, "bit_identical_repeat": same})
    if off.any() or abs(auc_p - aucs["fed kmeans"][0]) > 0.01:
        raise AssertionError("fed kmeans: the plain versions' fit disagrees "
                             "with the kernels' fit")
    emit({"phase": "fit_aucs",
          **{f"fed_{f}": aucs[f"fed {f}"][0]
             for f in ("mlp", "mf", "kmeans", "elo")},
          **{f"local_{f}_mean": sum(aucs[f"local {f}"]) / 3
             for f in ("mlp", "mf", "kmeans", "elo")},
          "oracle": oracle, "cheapest_model_acc": floor})
    return rows, fitted


def _holdout(torch, di: dict, seed: int, frac: float = 0.2) -> tuple:
    """fig. 5's split of one client's rows into fit and calibration sets
    through the w mask (20% held out for calibration)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    w = di["w"].cpu().numpy()
    idx = np.where(w > 0)[0]
    rng.shuffle(idx)
    cal = idx[:max(1, int(len(idx) * frac))]
    w_fit, w_cal = w.copy(), np.zeros_like(w)
    w_fit[cal], w_cal[cal] = 0.0, 1.0
    dev = di["w"].device
    return ({**di, "w": torch.as_tensor(w_fit, device=dev)},
            {**di, "w": torch.as_tensor(w_cal, device=dev)})


def features_phase(torch, dev, corpus, split, fitted: dict) -> list:
    """The paper's pool-evolution and privacy features at the §1 width,
    each a run with its own launch counts:

    * model onboarding (fig. 4, §6.3): every family fitted on 8 of the 11
      models of a fresh split, then the 3 withheld models added from a
      calibration set of 10% of each client's prompts — MLP and MF train
      only their new head columns (the rest must stay bit-identical),
      K-means and Elo estimate the new columns' statistics;
    * client onboarding (App. D.3): every family fitted on clients 0–6
      through ``client_mask``, then clients 7–9 join — MLP and MF by 15
      rounds of FedAvg on the new clients with distillation (β 1), K-means
      and Elo by exact statistics merges;
    * personalization (fig. 5, §6.4) on clients 0–2: the federated and a
      local router (fit on 80% of the client's rows, calibrated on the
      other 20%) mixed by calibration error, scored on the client's own
      test set, for MLP and K-means;
    * secure aggregation: the MLP FedAvg fit with pairwise masks at scale 0
      bit-identical to plain FedAvg on the same seed (3 rounds), and at
      scale 10 within 1e-6·scale·N per parameter after one round of N = 6
      active clients (each upload carries masks of ~scale·√N/w̃_i, rounded
      in f32 and weighted back by w̃_i)."""
    import dataclasses

    import numpy as np

    from repro_torch import routers
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.core import elo_router as EL
    from repro_torch.core import personalization as P
    from repro_torch.core import policy
    from repro_torch.data.partition import client_slice, federated_split
    from repro_torch.data.synthetic import observe
    from repro_torch.fed.aggregators import SecureAggAggregator
    from repro_torch.kernels import ops
    from repro_torch.train.optim import tree_leaves
    KA, KR = "kmeans_assign", "kmeans_assign_reduce"
    rcfg, fcfg = RouterConfig(), FedConfig()
    iters = rcfg.kmeans_iters
    one_shot = {"kmeans": {KR: 2 * iters, KA: 3}, "elo": {KR: 2 * iters, KA: 2}}
    rows = []

    def path(name, fn, owns, extra=None):
        out, row = run_fit(torch, ops, name, fn, owns, extra)
        rows.append(row)
        return out

    def auc(predict, te, models=None):
        acc, cost = te["acc_table"], te["cost_table"]
        if models is not None:
            acc, cost = acc[:, models], cost[:, models]
        return policy.eval_router(predict, te["x"], acc, cost)[2]

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # ---- model onboarding (fig. 4)
    M = rcfg.num_models
    base_models, withheld = list(range(M - 3)), list(range(M - 3, M))
    fcfg11 = dataclasses.replace(fcfg, seed=11)
    g = gen(70)
    split8 = federated_split(g, corpus, fcfg11, model_subset=base_models)
    tg8 = split8["test_global"]
    rng = np.random.default_rng(0)
    q = torch.as_tensor(np.concatenate([
        rng.choice(t, size=max(1, len(t) // 10), replace=False)
        for t in split8["train_idx"]]), device=dev)
    parts = []
    for m_new in withheld:
        a, c = observe(g, corpus, q, torch.full_like(q, m_new))
        parts.append({"x": corpus["x"][q],
                      "m": torch.full(q.shape, m_new, dtype=torch.int32,
                                      device=dev),
                      "acc": a, "cost": c, "w": torch.ones(q.shape,
                                                           device=dev)})
    calib = {k: torch.cat([pt[k] for pt in parts]) for k in parts[0]}
    band8, band11 = auc_bounds(torch, tg8, base_models), auc_bounds(torch, tg8)
    rcfg8 = RouterConfig(num_models=M - 3)
    res = {}
    for i, fam in enumerate(("mlp", "mf", "kmeans", "elo")):
        base = path(f"{fam} on {M - 3} of {M} models",
                    lambda: routers.fit_federated(
                        routers.make(fam, rcfg8), split8["train"], fcfg11,
                        gen=gen(71 + i), device=dev)[0],
                    one_shot.get(fam, {}))
        if fam in ("mlp", "mf"):
            grown = path(f"{fam} onboard {len(withheld)} models",
                         lambda: base.onboard_model(calib, gen=81 + i,
                                                    fcfg=fcfg11, n_new=3,
                                                    steps=400), {})
            frozen = "trunk" if fam == "mlp" else "proj"
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(grown.state[frozen]),
                tree_leaves(base.state[frozen])))
            same &= all(torch.equal(grown.state["heads"][k][..., :M - 3],
                                    base.state["heads"][k])
                        for k in base.state["heads"])
            if not same:
                raise AssertionError(f"{fam} model onboarding moved a "
                                     "frozen parameter")
        else:
            def add_all(base=base):
                r = base
                for pt in parts:
                    r = r.onboard_model({k: pt[k] for k in
                                         ("x", "acc", "cost", "w")})
                return r
            grown = path(f"{fam} onboard {len(withheld)} models", add_all,
                         {KA: len(withheld)} if fam == "kmeans" else {})
        if grown.num_models != M:
            raise AssertionError(f"{fam}: {grown.num_models} models after "
                                 "onboarding")
        A, C = grown.predict(tg8["x"])
        res[fam] = {"auc_before": auc(base.predict, tg8, base_models),
                    "auc_after": auc(grown.predict, tg8),
                    # how often a withheld model wins at the grid's
                    # smallest λ, where accuracy decides
                    "new_model_share_lam_0.01": float(
                        (torch.argmax(A - 0.01 * C, -1) >= M - 3).float()
                        .mean())}
        if fam == "elo":      # how peaked the anchor kernel is at this width
            res[fam]["kernel_max_weight_mean"] = float(EL.kernel_weights(
                tg8["x"], grown.state["anchors"], grown.state["tau"]).amax(
                -1).mean())
        check_auc(f"{fam} before onboarding", res[fam]["auc_before"], band8)
        check_auc(f"{fam} after onboarding", res[fam]["auc_after"], band11)
    emit({"phase": "onboard_models", "calibration_rows": int(q.numel()),
          "aucs": res, "cheapest_and_oracle_8": band8,
          "cheapest_and_oracle_11": band11})

    # ---- client onboarding (App. D.3)
    train, tg = split["train"], split["test_global"]
    band = auc_bounds(torch, tg)
    mask = (torch.arange(fcfg.num_clients, device=dev) < 7).float()
    new = {k: v[7:] for k, v in train.items()}
    res = {}
    for i, fam in enumerate(("mlp", "mf", "kmeans", "elo")):
        base = path(f"{fam} on clients 0-6 (client_mask)",
                    lambda: routers.fit_federated(
                        routers.make(fam, rcfg), train, fcfg, gen=gen(91 + i),
                        device=dev, client_mask=mask)[0],
                    one_shot.get(fam, {}))
        if fam in ("mlp", "mf"):
            joined = path(f"{fam} onboard clients 7-9",
                          lambda: base.onboard_clients(
                              new, gen=101 + i, fcfg=fcfg, rounds=15,
                              beta=1.0), {})
        else:
            joined = path(f"{fam} onboard clients 7-9",
                          lambda: base.onboard_clients(new),
                          {KA: 1} if fam == "kmeans" else {})
        res[fam] = {"auc_before": auc(base.predict, tg),
                    "auc_after": auc(joined.predict, tg)}
        for k, v in res[fam].items():
            check_auc(f"{fam} client onboarding {k}", v, band)
    emit({"phase": "onboard_clients", "aucs": res})

    # ---- personalization (fig. 5) on 3 clients
    fed, kfed = fitted["fed mlp"], fitted["fed kmeans"]
    res = []
    for i in range(3):
        te = split["test"][i]

        def personalize(i=i, te=te):
            fit_i, cal_i = _holdout(torch, client_slice(train, i), 100 + i)
            loc = routers.fit_local(routers.make("mlp", rcfg), fit_i, fcfg,
                                    gen=gen(110 + i), device=dev,
                                    steps=300)[0]
            kloc = routers.fit_local(routers.make("kmeans", rcfg), fit_i,
                                     fcfg, gen=gen(120 + i), device=dev)[0]
            ada, _ = P.make_personalized(fed.predict, loc.predict, cal_i, M)
            kada, _ = P.make_personalized(kfed.predict, kloc.predict, cal_i,
                                          M)
            return {"fed": auc(fed.predict, te),
                    "loc": auc(fitted[f"local mlp client {i}"].predict, te),
                    "ada": auc(ada, te), "kfed": auc(kfed.predict, te),
                    "kloc": auc(fitted[f"local kmeans client {i}"].predict,
                                te),
                    "kada": auc(kada, te)}
        r = path(f"personalize client {i}", personalize,
                 {KR: iters, KA: None}, lambda r: {"local_test_auc": r})
        for k, v in r.items():          # a client's own test set: any mix
            check_auc(f"personalization client {i} {k}", v, (0.0, 1.0))
        res.append(r)
    emit({"phase": "personalization", "clients": res,
          "mean": {k: sum(r[k] for r in res) / len(res) for k in res[0]}})

    # ---- secure aggregation
    def sfit(agg, rounds):
        return lambda: routers.fit_federated(
            routers.make("mlp", rcfg), train, fcfg, gen=gen(130), device=dev,
            rounds=rounds, aggregator=agg)[0]

    def max_diff(a, b):
        return max(float((x - y).abs().max()) for x, y in
                   zip(tree_leaves(a.state), tree_leaves(b.state)))

    plain3 = path("fedavg 3 rounds", sfit(None, 3), {})
    zero3 = path("secure agg scale 0, 3 rounds",
                 sfit(SecureAggAggregator(scale=0.0), 3), {})
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(plain3.state),
                                                 tree_leaves(zero3.state)))
    plain1 = path("fedavg 1 round", sfit(None, 1), {})
    ten1 = path("secure agg scale 10, 1 round",
                sfit(SecureAggAggregator(scale=10.0), 1), {})
    n_active = max(1, round(fcfg.participation * fcfg.num_clients))
    tol = 1e-6 * 10.0 * n_active
    d = max_diff(plain1, ten1)
    emit({"phase": "secure_agg", "scale0_bit_identical": same,
          "scale10_max_abs_diff": d, "scale10_tolerance": tol})
    if not same or not 0.0 < d <= tol:
        raise AssertionError(f"secure aggregation: scale 0 bit-identical "
                             f"{same}, scale 10 off by {d!r} (tolerance "
                             f"{tol!r})")
    return rows


def _union_us(spans) -> float:
    """Length of the union of (start, end, ...) intervals."""
    total, end = 0.0, float("-inf")
    for a, b, *_ in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_fit(torch, dev, split) -> None:
    """Where a fit's time goes at full width: one FedAvg round (6 active
    clients, ⌈D_max/128⌉ local steps) and one federated K-means fit, each
    timed bare and then traced with torch.profiler. Reports the device's
    busy time (the union of the kernels' spans) by kernel and its idle
    share of the bare wall time, and the Lloyd kernels' groups."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.core import federated as fed
    from repro_torch.core import kmeans_router as KR
    from repro_torch.core.mlp_router import init_mlp_router
    rcfg, fcfg = RouterConfig(), FedConfig()
    train = split["train"]
    gen = torch.Generator(device=dev).manual_seed(60)
    params = init_mlp_router(gen, rcfg)
    opt = fed._make_opt(fcfg, "adamw")
    steps = math.ceil(train["x"].shape[1] / fcfg.batch_size)
    work = {
        "fedavg_round": lambda: fed.fedavg_round(params, train, gen, rcfg,
                                                 fcfg, opt, steps),
        "fed_kmeans_router": lambda: KR.fed_kmeans_router(gen, train, rcfg),
    }
    cuda = torch.autograd.DeviceType.CUDA
    for name, fn in work.items():
        fn()                                               # warm-up
        _, bare = timed(torch, fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, traced = timed(torch, fn)
        kern = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.device_type == cuda]
        spans = [(e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == cuda]
        # kernels that start early (the reduction waits inside the
        # assignment's last wave) overlap: busy time is the union of the
        # kernels' spans, and a group's exclusive time is what the union
        # loses without it
        busy = _union_us(spans) / 1e3
        groups = {g: {"ms": sum(ms for k, ms, _ in kern if tag in k),
                      "launches": sum(c for k, _, c in kern if tag in k),
                      "exclusive_ms": busy - _union_us(
                          [sp for sp in spans if tag not in sp[2]]) / 1e3}
                  for g, tag in (("kmeans_assignment", "assign_kernel"),
                                 ("kmeans_reduction",
                                  "segment_reduce_kernel"))}
        emit({"phase": "profile_fit", "work": name, "groups": groups,
              "device_kernel_ms": sum(ms for _, ms, _ in kern),
              "local_steps": steps if name == "fedavg_round" else None,
              "wall_ms_bare": bare * 1e3, "wall_ms_traced": traced * 1e3,
              "device_busy_ms": busy,
              "device_idle_share": (1 - busy / (bare * 1e3)) if busy else None,
              "device_launches": sum(c for _, _, c in kern),
              "top": [{"kernel": n[:90], "ms": ms, "launches": c}
                      for n, ms, c in sorted(kern, key=lambda r: -r[1])[:6]]})


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


# ---------------------------------------------------------------------------
# The engine under overload, and speculative decode
# ---------------------------------------------------------------------------

#: a copy of ``benchmarks/perf_suite.py::_WORDS`` (nothing of the
#: benchmarks is imported here)
_WORDS = ("write solve prove summarize explain draft the a of this that "
          "integral poem theorem meeting notes carefully quickly now "
          "report plan code review data model chart essay story").split()


def deadline_traffic(seed: int, n_req: int, max_new: int, chunk: int,
                     slack: int, scale: float = 1.0, tail: float = 0.3,
                     long_words: tuple = (24, 57)) -> list:
    """A copy of ``benchmarks/perf_suite.py::_deadline_traffic``: long-tail
    Poisson arrivals on the engine-step clock (exponential gaps of mean
    ``scale`` steps) with deadlines of slack..2·slack service times, the
    long tail's 4× looser. The same seed gives the same events."""
    import numpy as np
    rng = np.random.default_rng(seed)
    steps = np.floor(np.cumsum(rng.exponential(scale, n_req))).astype(int)
    svc = -(-max_new // chunk)               # solo decode steps
    evs = []
    for i in range(n_req):
        long = rng.random() < tail
        n_words = int(rng.integers(*long_words) if long
                      else rng.integers(2, 13))
        loose = 4 if long else 1
        evs.append({"prompt": " ".join(rng.choice(_WORDS, n_words)),
                    "step": int(steps[i]),
                    "deadline": int(svc * slack * loose
                                    + rng.integers(0, svc * slack))})
    return evs


#: the reference's ``bench_preempt`` replay (BENCH_preempt.json's meta):
#: reduced qwen2-1.5b, pools of 64 pages / 2 and / 4
REPLAY = {"n_req": 48, "max_new": 32, "chunk": 8, "max_seq": 128,
          "page_size": 16, "slots": 8, "slack": 2, "scale": 0.25,
          "long_words": (24, 57)}
REPLAY_POLICIES = ("stall", "preempt", "shed")
#: the two high-water counters BENCH_preempt.json does not hold, as the
#: reference engine gives them on this replay: (queue_depth_hw,
#: peak_active) per (oversubscription, policy)
REPLAY_HW = {("2x", "stall"): (24, 8), ("2x", "preempt"): (21, 8),
             ("2x", "shed"): (8, 8), ("4x", "stall"): (34, 5),
             ("4x", "preempt"): (31, 8), ("4x", "shed"): (8, 5)}


def replay_expected() -> dict:
    """{(factor, policy): counts} the replay must reproduce, read from the
    reference's BENCH_preempt.json and ``REPLAY_HW``."""
    meta = json.loads((ROOT / "BENCH_preempt.json").read_text())["meta"]
    keys = ("met_tokens", "completed", "expiries", "sheds", "preemptions",
            "resume_recompute_toks")
    out = {}
    for f, cell in meta["oversub"].items():
        for mode in REPLAY_POLICIES:
            hw, peak = REPLAY_HW[(f, mode)]
            out[(f, mode)] = {**{k: cell[mode][k] for k in keys},
                              "queue_depth_hw": hw, "peak_active": peak}
    return out


def replay_server(torch, dev, pm, mode: str, factor: int):
    """The replay's server for one cell: ``stall`` is lifetime
    reservation, ``preempt`` initial reservation, ``shed`` lifetime with a
    queue cap of ``slots`` shedding the latest deadline; one model behind
    a one-cluster K-means router, as in the reference's bench."""
    from repro_torch import routers
    from repro_torch.config import RouterConfig
    from repro_torch.serve.engine import EngineConfig
    from repro_torch.serve.gateway import RoutedServer
    r = REPLAY
    kw = dict(slots=r["slots"], max_seq=r["max_seq"], chunk=r["chunk"],
              page_size=r["page_size"],
              pages=r["slots"] * (r["max_seq"] // r["page_size"]) // factor)
    if mode == "preempt":
        kw["reserve"] = "initial"
    elif mode == "shed":
        kw.update(queue_cap=r["slots"], shed_policy="reject-latest-deadline")
    router = routers.make(
        "kmeans", RouterConfig(d_emb=64, num_models=1),
        state={"centroids": torch.zeros((1, 64), device=dev),
               "A": torch.tensor([[0.9]], device=dev),
               "C": torch.tensor([[0.1]], device=dev),
               "n": torch.ones((1, 1), device=dev)})
    return RoutedServer([pm], router, engine_cfg=EngineConfig(**kw),
                        device=dev)


def run_deadline_traffic(srv, events, max_new: int) -> dict:
    """Replay a step-clock trace as the reference's
    ``_run_deadline_traffic`` does: submit each arrival at its step, one
    engine step per clock tick, drain. Returns the completed requests
    ({rid: tokens}), each rid's event, and the counts."""
    from repro_torch.serve.engine import DONE, PREEMPTED_RESUMED
    ev = sorted(events, key=lambda e: e["step"])
    meta, i, step = {}, 0, 0
    while i < len(ev) or srv.engine.busy:
        while i < len(ev) and ev[i]["step"] <= step:
            rid = srv.submit(ev[i]["prompt"], lam=0.5,
                             max_new_tokens=max_new,
                             deadline=ev[i]["deadline"])
            meta[rid] = ev[i]
            i += 1
        srv.step()
        step += 1
    res = srv.drain()
    eng = srv.engine
    completed = {r: res[r] for r in meta
                 if eng.status(r) in (DONE, PREEMPTED_RESUMED)}
    c = eng.counters()
    counts = {"met_tokens": int(sum(len(v) for v in completed.values())),
              "completed": len(completed),
              **{k: c[k] for k in ("expiries", "sheds", "preemptions",
                                   "resume_recompute_toks", "queue_depth_hw",
                                   "peak_active")}}
    return {"completed": completed, "meta": meta, "counts": counts}


def verify_kernel(torch, dev) -> None:
    """The speculative verify's attention at the served shapes
    (qwen2-1.5b Hkv 2 g 6, yi-6b 4/8, qwen3-8b 8/4; bf16, hd 128, 8 rows,
    T 4, windows across page boundaries, 16 pages of 16): the paged
    verify's one folded launch and the slot-pool verify's T launches must
    equal T one-position kernel calls bit for bit, and each row alone
    (B = 1) its row in the batch; both within the decode tolerance of the
    plain ``_masked_grouped_attn_multi``."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import paged_gather_ref
    from repro_torch.models import attention as A
    gen = torch.Generator(device=dev).manual_seed(17)
    B, T, hd, ps, npg = 8, 4, 128, 16, 16
    P = B * npg + 1
    pos = torch.tensor([14, 15, 29, 46, 63, 100, 158, 252], dtype=torch.int32,
                       device=dev)                 # 252 + 3 = 255: the end
    nv = A.verify_positions(pos, T) + 1            # (B, T) ≤ npg · ps
    valid = (torch.arange(npg * ps, device=dev)[None, None, :]
             < nv[:, :, None])
    res = {}
    for model, Hkv, g in (("qwen2-1.5b", 2, 6), ("yi-6b", 4, 8),
                          ("qwen3-8b", 8, 4)):
        qg = torch.randn((B, T, Hkv, g, hd), generator=gen,
                         device=dev).to(torch.bfloat16)
        kp, vp = (torch.randn((P, Hkv, ps, hd), generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        pt = torch.randperm(P - 1, generator=gen, device=dev)[
            :B * npg].reshape(B, npg).int() + 1
        k, v = paged_gather_ref(kp, pt), paged_gather_ref(vp, pt)
        paged = A.verify_attention_paged(qg, kp, vp, pt, nv)
        uniform = A.verify_attention(qg, k, v, nv)
        seq_p = torch.stack([ops.paged_decode_attention(
            qg[:, t], kp, vp, pt, nv[:, t].contiguous()) for t in range(T)],
            dim=1)
        seq_u = torch.stack([ops.decode_attention(
            qg[:, t], k, v, nv[:, t].contiguous()) for t in range(T)], dim=1)
        alone = torch.stack([torch.stack([ops.paged_decode_attention(
            qg[b:b + 1, t], kp, vp, pt[b:b + 1], nv[b:b + 1, t])[0]
            for t in range(T)]) for b in range(B)])
        torch.cuda.synchronize()
        for what, a, b in (("folded paged verify vs T paged calls", paged,
                            seq_p),
                           ("slot-pool verify vs T contiguous calls",
                            uniform, seq_u),
                           ("each row alone vs its row in the batch", alone,
                            seq_p),
                           ("paged vs contiguous", seq_p, seq_u)):
            if not torch.equal(a, b):
                raise AssertionError(f"verify {model}: {what} differ in "
                                     "their bits")
        plain = A._masked_grouped_attn_multi(
            qg.transpose(1, 2), k, v, valid).transpose(1, 2)
        rep = lambda t: t.repeat_interleave(T, dim=0)   # noqa: E731
        scale = da.decode_attention_plain(
            qg.float().reshape(B * T, Hkv, g, hd), rep(k), rep(v.abs()),
            nv.reshape(-1)).reshape(B, T, Hkv, g, hd)
        errs = [check_close(torch, got, plain, f"verify {model} {kind}",
                            scale) for kind, got in (("paged", paged),
                                                     ("uniform", uniform))]
        res[model] = {
            "max_abs_err": max(e for e, _ in errs),
            "err_over_tol": max(r for _, r in errs),
            "paged_device_ms": device_ms(torch, lambda: (
                A.verify_attention_paged(qg, kp, vp, pt, nv))),
            "uniform_device_ms": device_ms(torch, lambda: (
                A.verify_attention(qg, k, v, nv)))}
    emit({"phase": "verify_kernel", "T": T, "positions": pos.tolist(),
          "bit_equal": True, "shapes": res})


def resilience_replay(torch, dev) -> dict:
    """The reference's deadline replay (``bench_preempt``, reduced f32
    qwen2-1.5b) on the card, six cells: 2× and 4× page oversubscription
    under the stall, preempt and shed policies. Every count must equal the
    reference's, and every completed request of a preempt cell its solo
    tokens (preempted-and-resumed ones included)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serve.gateway import RoutedServer, make_pool_model
    r = REPLAY
    pm = make_pool_model("qwen2-1.5b", get_config("qwen2-1.5b").reduced(),
                         0.1, gen=torch.Generator(device=dev).manual_seed(2),
                         device=dev)
    events = deadline_traffic(0, r["n_req"], r["max_new"], r["chunk"],
                              slack=r["slack"], scale=r["scale"],
                              long_words=r["long_words"])
    solo = {}                            # uncounted: the per-call path
    for e in events:
        if e["prompt"] not in solo:
            toks = RoutedServer._tokenize([e["prompt"]], pm.cfg, None)
            solo[e["prompt"]] = RoutedServer._serve_batch(pm, toks,
                                                          r["max_new"])[0]
    want = replay_expected()
    cells = {}

    def fn():
        n = 0
        for f in (2, 4):
            for mode in REPLAY_POLICIES:
                out = run_deadline_traffic(replay_server(torch, dev, pm,
                                                         mode, f),
                                           events, r["max_new"])
                got = out["counts"]
                if got != want[(f"{f}x", mode)]:
                    raise AssertionError(f"replay {f}x {mode}: {got} vs the "
                                         f"reference's "
                                         f"{want[(f'{f}x', mode)]}")
                if mode == "preempt":
                    for rid, toks in out["completed"].items():
                        if list(toks) != list(solo[out["meta"][rid]
                                                   ["prompt"]]):
                            raise AssertionError(
                                f"replay {f}x preempt rid {rid}: resumed "
                                "tokens differ from solo")
                cells[f"{f}x {mode}"] = got
                n += got["met_tokens"]
        return n

    KA, PA = "kmeans_assign", "paged_decode_attention"
    row = run_path(torch, ops, "resilience replay (6 cells)", fn,
                   {KA: None, PA: None},
                   ("decode_attention", "router_utility",
                    "kmeans_assign_reduce", "flash_attention"))
    emit({"phase": "resilience_replay", "cells": cells,
          "equal_to_reference": True, "resume_equal_to_solo": True})
    return row


def _pool_state(eng) -> dict:
    """Every lane's pool storage and host bookkeeping, to hold the state
    after ``drain`` against the state before."""
    return {m: {"ptrs": [t.data_ptr() for layer in lane.pool.values()
                         for t in layer.values()],
                "free": sorted(lane.free),
                "pages": sorted(lane.pt.free) if lane.paged else None}
            for m, lane in eng._lanes.items()}


def resilience_full_width(torch, dev, pool) -> dict:
    """Overload at full width, bf16, both served models in one engine:
    initial reservation with half the pages full concurrency needs (32 of
    8 slots × 8 pages), 16 requests per lane of ``max_new`` 64 (growth
    crosses page boundaries), deadlines on half of them, one cancel of an
    active request and one of a queued one, and a yi-6b lane quota of 4
    that sheds. Every request must end in exactly one terminal status,
    submitted = completed + expired + cancelled + shed, preemptions > 0,
    and every lane's slots, pages and pool storage must be as before."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import (DONE, PREEMPTED_RESUMED,
                                          TERMINAL_STATUSES, EngineConfig,
                                          Outcome, ServeEngine)
    from repro_torch.serve.gateway import RoutedServer
    max_new = 64
    ecfg = EngineConfig(slots=8, max_seq=128, chunk=8, page_size=16,
                        pages=32, reserve="initial", lane_quotas=((1, 4),))
    eng = ServeEngine(pool, ecfg, device=dev)
    toks = {m: [RoutedServer._tokenize([p], pm.cfg, None)[0]
                for p in PROMPTS] for m, pm in enumerate(pool)}
    info = {}

    def submit(m, i):
        dl = 10 + 4 * (i % 4) if i % 2 else None
        return eng.submit(m, toks[m][i % len(PROMPTS)], max_new, deadline=dl)

    def fn():
        rids = [submit(m, i) for m in range(len(pool)) for i in range(8)]
        before = _pool_state(eng)
        eng.step()
        eng.cancel(rids[0])                          # active
        later = [submit(m, i) for m in range(len(pool))
                 for i in range(8, 16)]
        eng.cancel(later[7])                         # queued on lane 0
        rids += later
        done = eng.drain()
        statuses = [eng.status(r) for r in rids]
        if sorted(done) != sorted(rids) or any(
                s not in TERMINAL_STATUSES for s in statuses):
            raise AssertionError("full-width overload: a request without "
                                 "exactly one terminal status")
        c = eng.counters()
        completed = sum(s in (DONE, PREEMPTED_RESUMED) for s in statuses)
        if len(rids) != completed + c["expiries"] + c["cancels"] + c["sheds"]:
            raise AssertionError(f"full-width overload: {len(rids)} submitted"
                                 f", {completed} completed, {c}")
        if c["preemptions"] == 0 or c["cancels"] != 2 or c["sheds"] == 0:
            raise AssertionError(f"full-width overload exercised too little:"
                                 f" {c}")
        after = _pool_state(eng)
        if after != before:
            raise AssertionError("full-width overload: slots, pages or pool "
                                 "storage not back to their initial state")
        ntok = sum(len(v) for v in done.values()
                   if not isinstance(v, Outcome))
        info.update(counters=c, completed=completed, submitted=len(rids))
        return ntok

    row = run_path(torch, ops, "resilience full width", fn,
                   {"paged_decode_attention": None},
                   ("decode_attention", "router_utility", "kmeans_assign",
                    "kmeans_assign_reduce", "flash_attention"))
    emit({"phase": "resilience_full_width", **info,
          "pages": ecfg.resolved_pages, "max_new": max_new,
          "seconds": row["seconds"], "tok_per_s": row["tok_per_s"],
          "paged_launches": row["launches"]["paged_decode_attention"]})
    return row


# ---------------------------------------------------------------------------
# The federation side of the online loop: harvest, failover, robust and
# cohort fits
# ---------------------------------------------------------------------------

HARVEST_N = 64          # requests of the harvest phase, over 4 clients
FED_ROUNDS = 10         # full-width robust and cohort fits (FedConfig: 30)
REF_ROUNDS = 40         # bench_resilience's own
COHORT_ROUNDS = 5       # the cohort fits (cut from FED_ROUNDS)


def _score(rid: int, m: int) -> float:
    """The outcome a client reports for request ``rid`` served by ``m``."""
    return ((7 * rid + 3 * m) % 10) / 10.0


def harvest_full_width(torch, dev, pool) -> tuple:
    """Harvest at full width: qwen2-1.5b and yi-6b behind ``pool_router``'s
    MLP router with a ``HarvestStore(768, capacity=64)`` of 4 clients; 64
    requests at λ 0 and 2 with ``client_id``, one with a deadline that
    expires and one cancelled, every served one reported. The store must
    equal a host-side copy of every (x, model, score, cost), the expiry a
    zero score, the cancel nothing, and each unknown rid must say why.
    Then the MLP router is refitted from the harvest with the trimmed mean
    and a K-means router is fitted on it (#4 and #5), the MLP refit is
    swapped in (route = the refit's own route; #1 once per route bucket
    before and after) and a state of another shape is refused. Returns
    (the rows of its runs, the server)."""
    import numpy as np

    from repro_torch import routers
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.data.synthetic import make_eval_corpus
    from repro_torch.fed import HarvestStore, TrimmedMeanAggregator
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import CANCELLED, DONE, EXPIRED, Outcome
    from repro_torch.serve.gateway import RoutedServer
    RU, PA = "router_utility", "paged_decode_attention"
    UA, KA, KR, FA = ("decode_attention", "kmeans_assign",
                      "kmeans_assign_reduce", "flash_attention")
    t_phase = time.perf_counter()
    router = pool_router(torch, dev, "mlp")
    store = HarvestStore(768, capacity=64, clients=range(4), device=dev)
    srv = RoutedServer(pool, router, harvest=store, device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    xs = make_eval_corpus(gen, n_queries=HARVEST_N, n_tasks=8, n_models=2,
                          d_emb=768)["x"].cpu().numpy()
    rows, info = [], {}

    def serve():
        rids = []
        for i in range(HARVEST_N):
            rids.append(srv.submit(PROMPTS[i % len(PROMPTS)],
                                   lam=(0.0, 2.0)[i % 2],
                                   max_new_tokens=MAX_NEW, client_id=i % 4,
                                   x=xs[i], deadline=1 if i == 5 else None))
        routed = {r: srv.routed_model(r) for r in rids}
        srv.cancel(rids[HARVEST_N - 1])               # still queued
        done = srv.drain()
        info.update(rids=rids, routed=routed, done=done)
        return sum(len(v) for v in done.values()
                   if not isinstance(v, Outcome))

    rows.append(run_path(torch, ops, "harvest submit x64 + drain", serve,
                         {RU: HARVEST_N, PA: None}, (UA, KA, KR, FA)))
    rids, routed = info["rids"], info["routed"]
    status = {r: srv.status(r) for r in rids}
    expired, cancelled = rids[5], rids[HARVEST_N - 1]
    if status[expired] != EXPIRED or status[cancelled] != CANCELLED or any(
            status[r] != DONE for r in rids if r not in (expired,
                                                         cancelled)):
        raise AssertionError(f"harvest: statuses {status}")
    # the host-side copy, in the order the store records: the expiry while
    # draining, then the reports
    want = {c: [] for c in range(4)}
    cost = {r: pool[routed[r]].cost_per_token * MAX_NEW for r in rids}
    want[5 % 4].append((xs[5], routed[expired], 0.0, cost[expired]))
    for i, r in enumerate(rids):
        if status[r] == DONE:
            srv.report_outcome(r, _score(r, routed[r]))
            want[i % 4].append((xs[i], routed[r], _score(r, routed[r]),
                                cost[r]))
    for c, recs in want.items():
        got = store.buffer(c).as_client_data()
        n = len(recs)
        if (len(store.buffer(c)) != n
                or not np.array_equal(got["x"][:n],
                                      np.stack([r[0] for r in recs]))
                or got["m"][:n].tolist() != [r[1] for r in recs]
                or not np.array_equal(got["acc"][:n], np.array(
                    [r[2] for r in recs], np.float32))
                or not np.array_equal(got["cost"][:n], np.array(
                    [r[3] for r in recs], np.float32))):
            raise AssertionError(f"harvest: client {c}'s buffer differs "
                                 "from the host-side copy")
    reasons = {}
    for name, rid, why in (("reported", rids[0], "already reported"),
                           ("expired", expired, "EXPIRED past its deadline"),
                           ("cancelled", cancelled, "cancelled or shed")):
        try:
            srv.routed_model(rid)
            raise AssertionError(f"harvest: rid {rid} ({name}) still "
                                 "pending")
        except ValueError as e:
            if why not in str(e):
                raise AssertionError(f"harvest: rid {rid} ({name}): {e}")
            reasons[name] = str(e)
    served = [routed[r] for r in rids if status[r] == DONE]
    emit({"phase": "harvest_full_width", "rows": len(store),
          "rows_per_client": [len(store.buffer(c)) for c in range(4)],
          "served_by_model": [served.count(m) for m in range(len(pool))],
          "expiry_failures": srv.expiry_failures, "unknown_rid": reasons})

    # refit from the harvest: the served MLP router with the trimmed mean,
    # and a K-means router of the same M whose clients hold enough rows
    data = store.as_federated_data(pad_to=64)
    fcfg = FedConfig(num_clients=4, participation=1.0)
    min_rows = int(data["w"].sum(1).min())
    kcfg = RouterConfig(num_models=len(pool), k_local=min(15, min_rows))
    seed = lambda s: torch.Generator(device=dev).manual_seed(s)
    (mlp, _), row = run_fit(torch, ops, "harvest refit mlp trimmed_mean",
                            lambda: routers.fit_federated(
                                srv.router, data, fcfg, gen=seed(24),
                                device=dev, rounds=FED_ROUNDS,
                                aggregator=TrimmedMeanAggregator()), {})
    rows.append(row)
    iters = kcfg.kmeans_iters
    (km, _), row = run_fit(torch, ops, "harvest refit kmeans",
                           lambda: routers.fit_federated(
                               routers.make("kmeans", kcfg), data, fcfg,
                               gen=seed(25), device=dev),
                           {KR: 2 * iters, KA: 3},
                           lambda _: {"k_local": kcfg.k_local})
    rows.append(row)
    xt = torch.as_tensor(xs[:16], device=dev)
    choice, row = run_fit(torch, ops, "harvest kmeans route bucket of 16",
                          lambda: km.route(xt, 1.0), {KA: 1})
    rows.append(row)
    if not ((choice >= 0) & (choice < len(pool))).all():
        raise AssertionError("harvest: the K-means refit routes outside "
                             "the pool")

    # the hot swap: one route launch per bucket before and after
    def route_all():
        return np.concatenate([srv._route_x(xs[i:i + 16], lam)
                               for i in range(0, HARVEST_N, 16)
                               for lam in (0.0, 2.0)])
    n_buckets = 2 * HARVEST_N // 16
    before, row = run_fit(torch, ops, "route before swap", route_all,
                          {RU: n_buckets})
    rows.append(row)
    version = srv.router_version
    srv.swap_router_state(mlp.state)
    after, row = run_fit(torch, ops, "route after swap", route_all,
                         {RU: n_buckets})
    rows.append(row)
    own = np.concatenate([mlp.route(torch.as_tensor(xs[i:i + 16],
                                                    device=dev), lam)
                          .cpu().numpy() for i in range(0, HARVEST_N, 16)
                          for lam in (0.0, 2.0)])
    if srv.router_version != version + 1 or not np.array_equal(after, own):
        raise AssertionError("harvest: the swapped-in state routes other "
                             "than the refit itself")
    wrong = routers.make("mlp", RouterConfig(num_models=len(pool),
                                             hidden=(256,))).init(
        seed(26), device=dev)
    try:
        srv.swap_router_state(wrong.state)
        raise AssertionError("harvest: a state of another shape was "
                             "swapped in")
    except ValueError:
        pass
    emit({"phase": "harvest_swap", "router_version": srv.router_version,
          "routes_changed": int((before != after).sum()),
          "routes": int(before.size),
          "seconds": time.perf_counter() - t_phase})
    return rows, srv


def _predict_failover(plan, first: list, max_retries: int) -> tuple:
    """(served model per submit, backend_failures, retries, failovers) that
    ``plan.backend_fails`` gives submits routed first to ``first`` on a
    pool of two models (a failover goes to the other one; None where both
    fail, which the gateway refuses)."""
    served, fails, retries, failovers = [], 0, 0, 0
    for seq, m in enumerate(first):
        failed, attempt = set(), 0
        while m is not None and plan.backend_fails(m, seq, attempt):
            fails += 1
            if attempt < max_retries:
                attempt += 1
                retries += 1
                continue
            failed.add(m)
            if len(failed) == 2:
                m = None
            else:
                m, attempt = 1 - m, 0
                failovers += 1
        served.append(m)
    return served, fails, retries, failovers


def failover(torch, dev, pool, router) -> list:
    """Failover at full width behind the harvest phase's router: with
    ``FaultPlan(fail_models=(1,))`` every request lands on model 0, and
    with ``backend_fail=0.3`` (two fresh servers) each run's served models
    and ``backend_failures`` / ``retries`` / ``failovers`` equal what the
    plan's ``backend_fails`` predicts, a submit refused because both
    backends failed included. Returns the rows of its runs."""
    from repro_torch.data.encoder import encode
    from repro_torch.fed import FaultPlan, HarvestStore
    from repro_torch.kernels import ops
    from repro_torch.serve.gateway import RoutedServer
    RU, PA = "router_utility", "paged_decode_attention"
    others = ("decode_attention", "kmeans_assign", "kmeans_assign_reduce",
              "flash_attention")
    n = 16
    subs = [(PROMPTS[i % len(PROMPTS)], (0.0, 2.0)[i % 2]) for i in range(n)]
    first = [int(router.route(torch.as_tensor(encode([p], 768), device=dev),
                              lam)[0]) for p, lam in subs]
    rows, out = [], []
    for name, plan in (("hard down", FaultPlan(seed=11, fail_models=(1,))),
                       ("transient run 1", FaultPlan(seed=12,
                                                     backend_fail=0.3)),
                       ("transient run 2", FaultPlan(seed=12,
                                                     backend_fail=0.3))):
        srv = RoutedServer(pool, router, fault_plan=plan, device=dev,
                           harvest=HarvestStore(768, clients=range(4),
                                                device=dev))
        got = {}

        def fn(srv=srv, got=got):
            rids = []
            for i, (p, lam) in enumerate(subs):
                try:
                    rids.append(srv.submit(p, lam=lam, max_new_tokens=MAX_NEW,
                                           client_id=i % 4))
                except RuntimeError:          # every backend failed
                    rids.append(None)
            got["served"] = [None if r is None else srv.routed_model(r)
                             for r in rids]
            done = srv.drain([r for r in rids if r is not None])
            return sum(len(v) for v in done.values())

        row = run_path(torch, ops, f"failover {name}", fn,
                       {RU: n, PA: None}, others)
        rows.append(row)
        counts = (got["served"], srv.backend_failures, srv.retries,
                  srv.failovers)
        want = _predict_failover(plan, first, srv.max_retries)
        out.append({"run": name, "backend_failures": counts[1],
                    "retries": counts[2], "failovers": counts[3],
                    "served_by_model": [counts[0].count(m) for m in (0, 1)],
                    "refused": counts[0].count(None),
                    "predicted": list(want[1:])})
        if counts != want:
            raise AssertionError(f"failover {name}: {counts[1:]}, served "
                                 f"{counts[0]}; the plan predicts "
                                 f"{want[1:]}, served {want[0]}")
        if name == "hard down" and set(counts[0]) != {0}:
            raise AssertionError("failover: a request landed on the hard-"
                                 "down model")
    emit({"phase": "failover", "first_choice_by_model":
          [first.count(m) for m in (0, 1)], "runs": out})
    return rows


# ---------------------------------------------------------------------------
# The online loop: FedLoop at full width with a save and a restore, and the
# online-vs-frozen experiment
# ---------------------------------------------------------------------------

#: the full-width loop's traffic: 4 clients over the 2-model pool at d_emb
#: 768, two phases of 20 arrivals (64 until the script's time had to make
#: room for slice 11's phases, 32 until slice 13's; 20 still harvest the
#: 16 samples of a sync before the save)
FEDLOOP_SCENARIO = dict(n_clients=4, n_tasks=8, n_models=2, d_emb=768,
                        n_queries=2000, queries_per_phase=20, phases=2,
                        max_new=MAX_NEW)
#: ``BENCH_fedloop.json``'s scale (``bench_fedloop(smoke=False)``)
ONLINE_SCENARIO = dict(n_clients=8, queries_per_phase=256, phases=3,
                       n_queries=2000, test_queries=96)
#: ``tests/test_fedloop.py::test_online_scenario_smoke``'s scale
ONBOARD_SCENARIO = dict(n_clients=4, n_tasks=4, n_models=2, d_emb=16,
                        n_queries=400, queries_per_phase=24, phases=2,
                        test_queries=24, seed=0)


def _serve_phase(loop, scen, phase: int) -> tuple:
    """One scenario phase through the loop: every arrival submitted with
    its client, λ and embedding, its observed outcome reported, one engine
    chunk after each; then drained and a last sync offered. Returns
    ([(rid, routed model)], {rid: tokens})."""
    srv = loop.server
    routes, toks = [], {}
    for c, q, lam in scen.events(phase):
        rid = srv.submit(scen.prompt(q), lam=lam,
                         max_new_tokens=scen.cfg.max_new, client_id=c,
                         x=scen.x(q, phase))
        m = srv.routed_model(rid)
        routes.append((rid, m))
        srv.report_outcome(rid, *scen.observe(q, m))
        toks.update(loop.step())
    toks.update(loop.drain())
    loop.maybe_sync()
    return routes, toks


def _time_syncs(torch, loop, probe, out: list) -> None:
    """Record each sync of ``loop``: its seconds and how many of the probe
    queries route elsewhere after the swap (argmax of the router's own
    A − 0.5·C, computed without the route kernel so the launch counts stay
    those of the traffic)."""
    inner = loop.sync

    def choice():
        A, C = loop.server.router.predict(probe)
        return torch.argmax(A - 0.5 * C, dim=-1)

    def sync(**kw):
        before = choice()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = inner(**kw)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0,
                    int((choice() != before).sum())))
        return hist
    loop.sync = sync


def fedloop_full_width(torch, dev, pool) -> list:
    """The FedLoop over the served full-width pool: ``pool_router``'s MLP,
    a ``HarvestStore(768, capacity=64)`` of 4 clients, the traffic (x, λ
    and observed outcomes) of a ``TrafficScenario`` at d_emb 768, and
    ``FedLoopConfig(sync_every=8, rounds_per_sync=4, min_samples=16)``.
    Loop A serves phase 0, drains, syncs and saves, then serves phase 1;
    loop C, on a fresh server over the same pool, restores A's file and
    serves the same phase 1 (the clients' outcome stream rewound to the
    save). C's router state, routes, tokens, history, harvest, version and
    rid counter must equal A's bit for bit. Returns the rows of its runs."""
    import copy
    import tempfile

    import numpy as np

    from repro_torch.config import FedConfig
    from repro_torch.fed import (FedLoop, FedLoopConfig, HarvestStore,
                                 ScenarioConfig, TrafficScenario)
    from repro_torch.kernels import ops
    from repro_torch.serve.gateway import RoutedServer
    from repro_torch.train.optim import tree_leaves
    RU, PA = "router_utility", "paged_decode_attention"
    t_phase = time.perf_counter()
    router = pool_router(torch, dev, "mlp")
    scen = TrafficScenario(ScenarioConfig(**FEDLOOP_SCENARIO))
    n_ev = [len(scen.events(p)) for p in range(2)]
    fcfg = FedConfig(num_clients=4, participation=0.75, batch_size=32,
                     lr=3e-3)
    lcfg = FedLoopConfig(sync_every=8, rounds_per_sync=4, min_samples=16)
    probe = torch.as_tensor(scen.corpus["x"][:256], device=dev)

    def loop_on_fresh_server(seed):
        srv = RoutedServer(pool, router, device=dev, harvest=HarvestStore(
            768, capacity=64, clients=range(4), device=dev))
        return FedLoop(srv, fcfg, gen=seed, cfg=lcfg)

    syncs_a, syncs_c, io, res = [], [], {}, {}
    loop_a = loop_on_fresh_server(31)
    _time_syncs(torch, loop_a, probe, syncs_a)
    tmp = tempfile.TemporaryDirectory()
    path = Path(tmp.name) / "fedloop.ckpt"

    def run_a():
        _serve_phase(loop_a, scen, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop_a.save(path)
        io["save_s"] = time.perf_counter() - t0
        io["bytes"] = path.stat().st_size
        io["syncs_at_save"] = len(loop_a.history)
        res["outcomes"] = copy.deepcopy(scen._outcome_rng)
        res["a"] = _serve_phase(loop_a, scen, 1)

    loop_c = loop_on_fresh_server(32)
    _time_syncs(torch, loop_c, probe, syncs_c)

    def run_c():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop_c.restore(path)
        torch.cuda.synchronize()
        io["restore_s"] = time.perf_counter() - t0
        scen._outcome_rng = res["outcomes"]
        res["c"] = _serve_phase(loop_c, scen, 1)

    rows = []
    _, row = run_fit(torch, ops, "fedloop A: phase 0, save, phase 1",
                     run_a, {RU: n_ev[0] + n_ev[1], PA: None},
                     phase="fedloop")
    rows.append(row)
    _, row = run_fit(torch, ops, "fedloop C: restore, phase 1", run_c,
                     {RU: n_ev[1], PA: None}, phase="fedloop")
    rows.append(row)
    tmp.cleanup()

    # the restored loop continues bit for bit
    srv_a, srv_c = loop_a.server, loop_c.server
    (routes_a, toks_a), (routes_c, toks_c) = res["a"], res["c"]
    diffs = []
    sa, sc = srv_a.router.state, srv_c.router.state
    la, lc = tree_leaves(sa), tree_leaves(sc)
    if len(la) != len(lc) or not all(torch.equal(a, c)
                                     for a, c in zip(la, lc)):
        diffs.append("router state")
    if routes_a != routes_c:
        diffs.append("routes")
    if sorted(toks_a) != sorted(toks_c) or not all(
            np.array_equal(toks_a[r], toks_c[r]) for r in toks_a):
        diffs.append("tokens")
    keys = ("version", "loss", "samples")
    n_saved = io["syncs_at_save"]
    if (len(loop_a.history) != len(loop_c.history)
            or loop_a.history[:n_saved] != loop_c.history[:n_saved]
            or any({k: a[k] for k in keys} != {k: c[k] for k in keys}
                   for a, c in zip(loop_a.history, loop_c.history))):
        diffs.append("history")
    ha, hc = srv_a.harvest.state(), srv_c.harvest.state()
    if [c for c, _ in ha["clients"]] != [c for c, _ in hc["clients"]] or any(
            not np.array_equal(a[k], c[k]) for (_, a), (_, c) in
            zip(ha["clients"], hc["clients"]) for k in a):
        diffs.append("harvest")
    if srv_a.router_version != srv_c.router_version:
        diffs.append("router_version")
    if srv_a.engine._next_rid != srv_c.engine._next_rid:
        diffs.append("next_rid")
    if diffs:
        raise AssertionError(f"fedloop: the restored loop's phase 1 differs "
                             f"from the uninterrupted loop's in {diffs}")
    if not loop_a.history or len(srv_a.harvest) == 0:
        raise AssertionError("fedloop: loop A never synced")
    emit({"phase": "fedloop_full_width", "events": n_ev,
          "syncs": len(loop_a.history), "syncs_at_save": n_saved,
          "router_version": srv_a.router_version,
          "rows_per_client": [len(srv_a.harvest.buffer(c))
                              for c in range(4)],
          "routes_changed_per_sync": [n for _, n in syncs_a],
          "probe_routes": int(probe.shape[0]),
          "seconds_per_sync": [s for s, _ in syncs_a],
          "restored_seconds_per_sync": [s for s, _ in syncs_c],
          "launches_a": {k: rows[0]["launches"][k] for k in (RU, PA)},
          "launches_c": {k: rows[1]["launches"][k] for k in (RU, PA)},
          "save_seconds": io["save_s"], "restore_seconds": io["restore_s"],
          "checkpoint_bytes": io["bytes"],
          "engine_last_sync": loop_a.history[-1]["engine"],
          "restored_engine_last_sync": loop_c.history[-1]["engine"],
          "bit_identical": True,
          "seconds": time.perf_counter() - t_phase})
    return rows


def _bench_fedloop() -> dict:
    """``BENCH_fedloop.json``'s values (the JAX package on a CPU, another
    corpus): printed beside the card's, a comparison, not a check."""
    meta = json.loads((ROOT / "BENCH_fedloop.json").read_text())["meta"]
    return {k: meta[k] for k in ("auc_online", "auc_frozen_local",
                                 "auc_gap_final", "syncs",
                                 "requests_served", "harvested_samples")}


def _check_online(name: str, m: dict) -> None:
    aucs = m["auc_online"] + m["auc_frozen_local"]
    if not all(0.0 <= a <= 1.0 for a in aucs):
        raise AssertionError(f"{name}: an AUC outside [0, 1]: {aucs}")
    if m["syncs"] < 1:
        raise AssertionError(f"{name}: no sync")
    if m["requests_served"] != m["harvested_samples"]:
        raise AssertionError(f"{name}: served {m['requests_served']}, "
                             f"harvested {m['harvested_samples']}")


def online_vs_frozen(torch, dev) -> list:
    """``run_online_vs_frozen`` on the card at ``BENCH_fedloop.json``'s
    scale with the reference's default loop, fit and router configs, once;
    at ``test_online_scenario_smoke``'s scale twice (the second call must
    return the same dict; this check ran at the larger scale until the
    script's time had to make room for slice 11's phases); and once at
    that scale with a model onboarded at phase 1: the pool ends at 3
    models and every phase-1 route launches #1 on the expanded head.
    Returns the rows of its runs."""
    from repro_torch.fed import (ScenarioConfig, TrafficScenario,
                                 run_online_vs_frozen)
    from repro_torch.kernels import ops
    from repro_torch.kernels import router_utility as ru
    RU, PA = "router_utility", "paged_decode_attention"
    cfg = ScenarioConfig(**ONLINE_SCENARIO)
    n_req = sum(len(TrafficScenario(cfg).events(p))
                for p in range(cfg.phases))
    big, row = run_fit(torch, ops, "online vs frozen",
                       lambda: run_online_vs_frozen(cfg, device=dev),
                       {RU: n_req, PA: None}, phase="online_vs_frozen")
    _check_online("online_vs_frozen", big)
    rows, runs = [row], []
    ocfg = ScenarioConfig(**ONBOARD_SCENARIO)
    n_small = sum(len(TrafficScenario(ocfg).events(p))
                  for p in range(ocfg.phases))
    for i in (1, 2):
        m, row = run_fit(torch, ops, f"online vs frozen smoke run {i}",
                         lambda: run_online_vs_frozen(ocfg, device=dev),
                         {RU: n_small, PA: None}, phase="online_vs_frozen")
        rows.append(row)
        runs.append(m)
        _check_online("online_vs_frozen smoke", m)
    if runs[0] != runs[1]:
        raise AssertionError(f"online_vs_frozen: a second run differs: "
                             f"{runs[0]} vs {runs[1]}")

    # onboarding: the head each route launch sees
    osc = TrafficScenario(ocfg, n_reserved_models=1)
    n_ev = [len(osc.events(p)) for p in range(ocfg.phases)]
    heads = []
    launch = ru.router_utility_cuda

    def spy(h, acc_w, *a):
        heads.append(int(acc_w.shape[1]))
        return launch(h, acc_w, *a)
    ru.router_utility_cuda = spy
    try:
        mo, row = run_fit(torch, ops, "online vs frozen onboarding",
                          lambda: run_online_vs_frozen(
                              ocfg, onboard_phase=1, local_steps=60,
                              capacity=64, device=dev),
                          {RU: sum(n_ev), PA: None},
                          phase="online_vs_frozen")
    finally:
        ru.router_utility_cuda = launch
    rows.append(row)
    _check_online("online_vs_frozen onboarding", mo)
    if mo["num_models_final"] != 3 or heads != [2] * n_ev[0] + [3] * n_ev[1]:
        raise AssertionError(f"online_vs_frozen onboarding: M "
                             f"{mo['num_models_final']}, heads per launch "
                             f"{heads}")
    emit({"phase": "online_vs_frozen", "scale": ONLINE_SCENARIO,
          "seconds": rows[0]["seconds"], **big,
          "bench_fedloop_json": _bench_fedloop(),
          "smoke_twice": {"scale": ONBOARD_SCENARIO,
                          "same_dict_twice": True,
                          "seconds_per_run": [r["seconds"]
                                              for r in rows[1:3]],
                          **runs[0]},
          "onboarding": {"scale": ONBOARD_SCENARIO, **mo,
                         "launches_by_head": {"2": heads.count(2),
                                              "3": heads.count(3)},
                         "seconds": rows[3]["seconds"]}})
    return rows


def _flip_labels(torch, train: dict, mask) -> dict:
    """Label-flip fault at the data layer: the masked clients report
    inverted accuracies (acc → 1 − acc on their real rows), as
    ``benchmarks/perf_suite.py::_flip_labels`` does."""
    bad = torch.as_tensor(mask, device=train["acc"].device)
    flip = bad[:, None] & (train["w"] > 0)
    return {**train, "acc": torch.where(flip, 1.0 - train["acc"],
                                        train["acc"])}


def reference_scale_split(torch, dev) -> dict:
    """``bench_resilience``'s corpus at its own scale (1,500 queries, 5
    tasks, 6 models, d_emb 16) and its split over 8 clients."""
    from repro_torch.config import FedConfig
    from repro_torch.data.partition import federated_split
    from repro_torch.data.synthetic import make_eval_corpus
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = make_eval_corpus(gen, n_queries=1500, n_tasks=5, n_models=6,
                              d_emb=16)
    return federated_split(gen, corpus, FedConfig(num_clients=8))


def resilience_table(torch, dev, split) -> list:
    """Robust aggregation under Byzantine clients, two sizes.

    * Full width: the MLP router at d_emb 768, 11 models, 10 clients, the
      36,000-query split, ``FedConfig(participation=1.0)``, 10 rounds (cut
      from 30); fedavg, trimmed mean and median, each clean and under
      ``FaultPlan(seed=3, corrupt_frac=0.25)``'s sign flip.
    * The reference benchmark's own scale (``bench_resilience``: d_emb 16,
      6 models, 8 clients, 1,500 queries, hidden (32, 32), 40 rounds): the
      four strategies under the four fault classes.

    Every clean AUC, and every AUC of the trimmed mean and median under
    attack, must lie between the cheapest model's accuracy and the
    oracle's AUC at full width; at the reference scale the upper end is
    the oracle's accuracy (each query's best model), since there a fit's
    frontier AUC can pass the oracle's in both packages (``frontier_auc``
    normalises each frontier by its own cost range; the oracle's AUC is
    printed beside it). A corrupted fedavg or norm-clip fit need only be
    finite. Under sign flip the trimmed mean and the median must both beat
    fedavg at both sizes. Each AUC is printed beside ``BENCH_resilience.json``'s
    (JAX on a CPU: no equality expected)."""
    from repro_torch import routers
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.core import policy
    from repro_torch.fed import (FaultPlan, FedAvgAggregator,
                                 MedianAggregator, NormClipAggregator,
                                 TrimmedMeanAggregator)
    from repro_torch.kernels import ops
    plan = FaultPlan(seed=3, corrupt_frac=0.25)
    aggs = {"fedavg": FedAvgAggregator(),
            "trimmed_mean": TrimmedMeanAggregator(trim_frac=0.25),
            "median": MedianAggregator(),
            "norm_clip": NormClipAggregator(clip=0.5)}
    # BENCH_resilience.json's table (JAX on a CPU), read as data
    ref = json.loads((ROOT / "BENCH_resilience.json").read_text())[
        "meta"]["corruption_auc"]
    rows = []

    def table(size, rcfg, fcfg, sp, rounds, names, modes, by_accuracy):
        train, tg = sp["train"], sp["test_global"]
        n = fcfg.num_clients
        floor, oracle = auc_bounds(torch, tg)
        best = float(tg["acc_table"].max(1).values.mean())
        band = (floor, best if by_accuracy else oracle)
        out = {}
        for name in names:
            out[name] = {}
            for mode in ("clean",) + modes:
                data, agg = train, aggs[name]
                if mode == "label_flip":
                    data = _flip_labels(torch, train,
                                        plan.corrupted_clients(n))
                elif mode != "clean":
                    agg = plan.corrupt_updates(n, inner=agg, mode=mode)
                gen = torch.Generator(device=dev).manual_seed(5)
                (r, _), row = run_fit(
                    torch, ops, f"resilience {size} {name} {mode}",
                    lambda: routers.fit_federated(
                        routers.make("mlp", rcfg), data, fcfg, gen=gen,
                        device=dev, rounds=rounds, aggregator=agg), {})
                rows.append(row)
                auc = policy.eval_router(r.predict, tg["x"],
                                         tg["acc_table"],
                                         tg["cost_table"])[2]
                out[name][mode] = auc
        emit({"phase": "resilience_table", "size": size, "rounds": rounds,
              "clients": n, "corrupted": plan.corrupted_clients(n)
              .nonzero()[0].tolist(), "cheapest_model_acc": floor,
              "oracle": oracle, "oracle_accuracy": best, "band": band,
              "auc": out,
              "bench_resilience_json": {k: ref[k] for k in names}})
        for name, by_mode in out.items():
            for mode, auc in by_mode.items():
                what = f"resilience {size} {name} {mode}"
                if mode == "clean" or name in ("trimmed_mean", "median"):
                    check_auc(what, auc, band)
                elif not math.isfinite(auc):
                    raise AssertionError(f"{what}: AUC {auc!r}")
        for name in ("trimmed_mean", "median"):
            if not out[name]["sign_flip"] > out["fedavg"]["sign_flip"]:
                raise AssertionError(
                    f"resilience {size}: {name} under sign flip "
                    f"{out[name]['sign_flip']!r} does not beat fedavg's "
                    f"{out['fedavg']['sign_flip']!r}")

    t0 = time.perf_counter()
    table("full width", RouterConfig(),
          FedConfig(participation=1.0), split, FED_ROUNDS,
          ("fedavg", "trimmed_mean", "median"), ("sign_flip",), False)
    t1 = time.perf_counter()
    rcfg = RouterConfig(d_emb=16, num_models=6, hidden=(32, 32), dropout=0.0)
    fcfg = FedConfig(num_clients=8, participation=1.0, batch_size=32,
                     lr=3e-3)
    table("reference scale", rcfg, fcfg, reference_scale_split(torch, dev),
          REF_ROUNDS, tuple(aggs), ("sign_flip", "scaled_noise",
                                    "label_flip"), True)
    emit({"phase": "resilience_table_seconds", "full_width": t1 - t0,
          "reference_scale": time.perf_counter() - t1})
    return rows


def cohort_fit(torch, dev, split) -> list:
    """At full width: one 5-round MLP fit each with ``cohort`` None, 5 and
    3 under ``FedConfig(participation=1.0)``; each must aggregate stacks
    of exactly its cohort's size every round (10 without one). Prints the
    seconds per fit."""
    from repro_torch import routers
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.fed import FedAvgAggregator
    from repro_torch.kernels import ops

    class StackSizes(FedAvgAggregator):
        """FedAvg recording the size of each stack it aggregates."""

        def __call__(self, client_params, wts, gen):
            self.__dict__.setdefault("sizes", []).append(int(wts.shape[0]))
            return super().__call__(client_params, wts, gen)

    fcfg = FedConfig(participation=1.0)
    rows, secs = [], {}
    for cohort in (None, 5, 3):
        spy = StackSizes()
        gen = torch.Generator(device=dev).manual_seed(6)
        _, row = run_fit(torch, ops, f"cohort {cohort}", lambda: (
            routers.fit_federated(routers.make("mlp", RouterConfig()),
                                  split["train"], fcfg, gen=gen, device=dev,
                                  rounds=COHORT_ROUNDS, cohort=cohort,
                                  aggregator=spy), None), {})
        rows.append(row)
        want = [cohort or fcfg.num_clients] * COHORT_ROUNDS
        if spy.sizes != want:
            raise AssertionError(f"cohort {cohort}: aggregated stacks of "
                                 f"{spy.sizes}, expected {want}")
        secs[str(cohort)] = row["seconds"]
    emit({"phase": "cohort_fit", "rounds": COHORT_ROUNDS,
          "seconds_per_fit": secs})
    return rows


SPEC_K = 4
SPEC_NEW = 32


def _spec_pool(torch, dev, pool, reduced: bool):
    """The three-model speculative pool: qwen2-1.5b (cost 0.05), yi-6b
    (0.4) and qwen3-8b (0.6) behind a 3-model MLP router. ``pool`` holds
    the first two; qwen3-8b is made here."""
    from repro_torch import routers
    from repro_torch.config import RouterConfig
    from repro_torch.configs import get_config
    from repro_torch.serve.gateway import make_pool_model
    gen = torch.Generator(device=dev).manual_seed(3)
    cfg = get_config("qwen3-8b")
    q3 = make_pool_model("qwen3-8b", cfg.reduced() if reduced else cfg, 0.6,
                         gen=gen, device=dev)
    router = routers.make("mlp", RouterConfig(num_models=3)).init(gen,
                                                                  device=dev)
    return list(pool) + [q3], router


def _spec_pairs(srv, pool) -> list:
    """(target, drafter) per lane, the drafter from ``_pick_draft`` on the
    first prompt at λ 0.5."""
    from repro_torch.data.encoder import encode
    x = encode(PROMPTS[:1], srv.d_emb)[0]
    return [(m, srv._pick_draft(m, x, 0.5)) for m in range(len(pool))]


def _lane_run(eng, pool, m: int, draft=None, n: int = 4,
              max_new: int = SPEC_NEW) -> tuple:
    """``n`` prompts straight into lane ``m``; returns (their tokens in
    submit order, the counters' change)."""
    from repro_torch.serve.gateway import RoutedServer
    c0 = eng.counters()
    rids = [eng.submit(m, RoutedServer._tokenize([p], pool[m].cfg, None)[0],
                       max_new, draft=draft) for p in PROMPTS[:n]]
    done = eng.drain(rids)
    c = {k: v - c0[k] for k, v in eng.counters().items()}
    return [done[r] for r in rids], c


def spec_full_width(torch, dev, pool) -> list:
    """Speculative decode at full width, bf16, ``spec_k`` 4: qwen3-8b
    drafted by qwen2-1.5b (the router's pick: the one cheaper model with
    its vocabulary), qwen2-1.5b and yi-6b drafting for themselves. Per
    pair: the counters, acceptance, launches, tokens/s and agreement with
    the plain engine's tokens (printed: random bf16 weights leave
    near-ties, and the verify's GEMMs have B·T rows)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import EngineConfig
    from repro_torch.serve.gateway import RoutedServer
    pool3, router = _spec_pool(torch, dev, pool, reduced=False)
    spec = RoutedServer(pool3, router, device=dev,
                        engine_cfg=EngineConfig(spec_k=SPEC_K))
    plain = RoutedServer(pool3, router, device=dev)
    pairs = _spec_pairs(spec, pool3)
    if pairs != [(0, 0), (1, 1), (2, 0)]:
        raise AssertionError(f"drafter pairs {pairs}: expected qwen3-8b "
                             "drafted by qwen2-1.5b, the others by "
                             "themselves")
    UA, PA = "decode_attention", "paged_decode_attention"
    others = ("router_utility", "kmeans_assign", "kmeans_assign_reduce",
              "flash_attention")
    for m, d in pairs:                               # warm-up, uncounted
        _lane_run(plain.engine, pool3, m, n=1, max_new=8)
        _lane_run(spec.engine, pool3, m, draft=d, n=1, max_new=8)
    rows, res = [], {}
    for m, d in pairs:
        tgt, drf = pool3[m].name, pool3[d].name
        base = {}

        def plain_fn(m=m):
            base["toks"], _ = _lane_run(plain.engine, pool3, m)
            return sum(len(t) for t in base["toks"])

        name = f"lane {tgt} x4" + ("" if m == 2 else f" max_new {SPEC_NEW}")
        prow = run_path(torch, ops, name, plain_fn, {PA: None},
                        (UA,) + others)
        got = {}

        def spec_fn(m=m, d=d):
            got["toks"], got["c"] = _lane_run(spec.engine, pool3, m, draft=d)
            return sum(len(t) for t in got["toks"])

        srow = run_path(torch, ops, f"spec {tgt} drafted by {drf} x4",
                        spec_fn, {UA: None, PA: None}, others)
        c = got["c"]
        if c["spec_drafted"] != c["spec_accepted"] + c["spec_rejected"]:
            raise AssertionError(f"spec {tgt}: counters {c}")
        agree = sum(int((a == b).sum()) for a, b in zip(got["toks"],
                                                        base["toks"]))
        res[f"{tgt} <- {drf}"] = {
            **{k: c[k] for k in ("spec_rounds", "spec_drafted",
                                 "spec_accepted", "spec_rejected")},
            "acceptance": c["spec_accepted"] / c["spec_drafted"],
            "agree_with_plain": agree / (4 * SPEC_NEW),
            "spec_tok_per_s": srow["tok_per_s"],
            "plain_tok_per_s": prow["tok_per_s"],
            "launches": {k: srow["launches"][k] for k in (UA, PA)}}
        rows += [prow, srow]
    emit({"phase": "spec_full_width", "spec_k": SPEC_K, "max_new": SPEC_NEW,
          "params": [mdl.param_count(pm.params) for pm in pool3],
          "pairs": res})
    return rows


def spec_reduced_f32(torch, dev) -> list:
    """The same three-model pool reduced to f32, paged and uniform lanes:
    speculative tokens must equal the plain engine's exactly, for the
    router-paired drafters and for self-drafting; self-drafting accepts
    every draft; drafted = accepted + rejected."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import EngineConfig, ServeEngine
    from repro_torch.serve.gateway import RoutedServer, make_pool_model
    gen = torch.Generator(device=dev).manual_seed(4)
    pool = [make_pool_model(a, get_config(a).reduced(), c, gen=gen,
                            device=dev)
            for a, c in (("qwen2-1.5b", 0.05), ("yi-6b", 0.4))]
    pool3, router = _spec_pool(torch, dev, pool, reduced=True)
    pairs = _spec_pairs(RoutedServer(pool3, router, device=dev), pool3)
    res = {}

    def fn():
        n = 0
        for page_size in (16, None):
            plain = ServeEngine(pool3, EngineConfig(page_size=page_size),
                                device=dev)
            spec = ServeEngine(pool3, EngineConfig(page_size=page_size,
                                                   spec_k=SPEC_K), device=dev)
            for m, d in sorted(set(pairs) | {(m, m) for m, _ in pairs}):
                base, _ = _lane_run(plain, pool3, m)
                toks, c = _lane_run(spec, pool3, m, draft=d)
                what = (f"spec reduced {pool3[m].name} drafted by "
                        f"{pool3[d].name}, page_size {page_size}")
                if any(list(a) != list(b) for a, b in zip(toks, base)):
                    raise AssertionError(f"{what}: tokens differ from the "
                                         "plain engine's")
                if c["spec_drafted"] != c["spec_accepted"] + c["spec_rejected"]:
                    raise AssertionError(f"{what}: counters {c}")
                if m == d and c["spec_accepted"] != c["spec_drafted"]:
                    raise AssertionError(f"{what}: self-drafting rejected "
                                         f"drafts: {c}")
                res[what] = c["spec_accepted"] / c["spec_drafted"]
                n += sum(len(t) for t in toks)
        return n

    row = run_path(torch, ops, "spec reduced f32", fn,
                   {"decode_attention": None, "paged_decode_attention": None},
                   ("router_utility", "kmeans_assign",
                    "kmeans_assign_reduce", "flash_attention"))
    emit({"phase": "spec_reduced_f32", "equal": True, "acceptance": res})
    return [row]


# ---------------------------------------------------------------------------
# MoE, SSM and hybrid models
# ---------------------------------------------------------------------------


def _cut(cfg, n_layers: int):
    """``cfg`` at its full width, cut to ``n_layers`` layers."""
    import dataclasses
    return dataclasses.replace(cfg, n_layers=n_layers)


def _steered_router(torch, dev, gen):
    """An MLP router over 2 models whose head biases steer λ 0 to model 0
    (accuracy logit +6) and λ 2 to model 1 (model 0's cost +4): the
    random trunk decides nothing, so both lanes are sure to be served."""
    from repro_torch import routers
    from repro_torch.config import RouterConfig
    router = routers.make("mlp", RouterConfig(num_models=2)).init(gen,
                                                                  device=dev)
    heads = dict(router.state["heads"])
    heads["acc_b"] = torch.tensor([6.0, 0.0], device=dev)
    heads["cost_b"] = torch.tensor([4.0, 0.0], device=dev)
    return router.with_state({**router.state, "heads": heads})


def profile_moe_decode(torch, srv, m: int) -> dict:
    """One full-width MoE lane holding 8 requests: one engine step (a chunk
    of ``chunk`` decode steps) timed bare, then traced with torch.profiler.
    Per decode step: wall time, device busy time and the weight-read
    bound. The dense dispatch reads every expert of every layer each step,
    so the bound is every weight but the token table (of which a step
    reads 8 rows) over the HBM rate."""
    pm = srv.pool[m]
    bare, traced, kern = _traced_step(torch, srv, [m])
    n = srv.engine.ecfg.chunk
    busy = sum(ms for _, ms, _ in kern)
    wbytes = _nbytes(pm.params) - _nbytes(pm.params["embed"]["tok"])
    row = {"phase": "moe_decode_profile", "model": pm.name,
           "layers": pm.cfg.n_layers, "decode_rows": 8, "decode_steps": n,
           "step_ms_bare": bare * 1e3 / n, "step_ms_traced": traced * 1e3 / n,
           "device_busy_ms": busy / n,
           "device_idle_share": (1 - busy / (bare * 1e3)) if busy else None,
           "weight_gb": wbytes / 1e9,
           "weights_read_bound_ms": wbytes
           / data_sheet()["hbm_bytes_per_s"] * 1e3,
           "top": [{"kernel": k[:90], "ms": ms / n, "launches": c / n}
                   for k, ms, c in sorted(kern, key=lambda r: -r[1])[:6]]}
    row["bound_over_busy"] = (row["weights_read_bound_ms"]
                              / row["device_busy_ms"] if busy else None)
    emit(row)
    return row


def _arch_pool_row(torch, dev, pool, t0) -> None:
    from repro_torch.models import model as mdl
    emit({"phase": "arch_pool", "models": [pm.name for pm in pool],
          "layers": [pm.cfg.n_layers for pm in pool],
          "params": [mdl.param_count(pm.params) for pm in pool],
          "active_params": [mdl.active_param_count(pm.params, pm.cfg)
                            for pm in pool],
          "init_seconds": time.perf_counter() - t0,
          "mem_gib": torch.cuda.memory_allocated(dev) / 2 ** 30})


def arch_full_width(torch, dev) -> list:
    """phi-3.5-MoE at full width cut to 16 of its 32 layers (all 32 need
    84 GB in bf16) and mamba2-370m whole (48 layers), random bf16 weights,
    behind one MLP router steered so that λ 0 serves phi on the paged
    engine and λ 2 serves mamba2 on the per-call path (SSM state cannot
    share padded buckets); then phi on the per-call path (engine=False).
    The launch counters show the router (#1), the paged kernel (#3, once
    per layer per decode step) and the contiguous kernel (#2); every
    request is answered. Then phi's decode step against its weight-read
    bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serve.gateway import RoutedServer, make_pool_model
    gen = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    phi = _cut(get_config("phi3.5-moe-42b-a6.6b"), 16)
    pool = [make_pool_model(phi.name, phi, 0.4, gen=gen, device=dev),
            make_pool_model("mamba2-370m", get_config("mamba2-370m"), 0.05,
                            gen=gen, device=dev)]
    srv = RoutedServer(pool, _steered_router(torch, dev, gen), device=dev)
    torch.cuda.synchronize()
    _arch_pool_row(torch, dev, pool, t0)
    for lam in (0.0, 2.0):                     # warm-up, uncounted
        for kw in ({}, {"engine": False}):
            check_result(srv.generate(PROMPTS[:2], lam=lam,
                                      max_new_tokens=MAX_NEW, **kw), pool, 2)
    UA, PA, RU = "decode_attention", "paged_decode_attention", "router_utility"
    KA, KR, FA = "kmeans_assign", "kmeans_assign_reduce", "flash_attention"
    routed = {}

    def gen_fn(lam, **kw):
        def fn():
            out = srv.generate(PROMPTS, lam=lam, max_new_tokens=MAX_NEW, **kw)
            routed[lam, kw.get("engine", True)] = out["routing"]
            return check_result(out, pool, len(PROMPTS))
        return fn

    rows = [run_path(torch, ops, "arch generate lam=0.0 (phi on the engine)",
                     gen_fn(0.0), {RU: 1, PA: None}, (UA, KA, KR, FA)),
            run_path(torch, ops, "arch generate lam=2.0 (mamba2 per call)",
                     gen_fn(2.0), {RU: 1}, (UA, PA, KA, KR, FA)),
            run_path(torch, ops, "arch generate lam=0.0 engine=False",
                     gen_fn(0.0, engine=False), {RU: 1, UA: None},
                     (PA, KA, KR, FA))]
    if rows[0]["launches"][PA] % phi.n_layers:
        raise AssertionError(f"phi lane: {rows[0]['launches'][PA]} paged "
                             f"launches, not a multiple of {phi.n_layers}")
    for (lam, _), r in routed.items():
        if set(r) != {0 if lam == 0.0 else 1}:
            raise AssertionError(f"λ {lam} routed {r}: the steered router "
                                 "should send every request to one model")
    prof = profile_moe_decode(torch, srv, 0)
    emit({"phase": "arch_full_width", "routing": {
        f"lam={lam} engine={e}": r for (lam, e), r in routed.items()},
        "tok_per_s": {r["path"]: r["tok_per_s"] for r in rows},
        "phi_decode_step_ms": prof["step_ms_bare"],
        "phi_weights_read_bound_ms": prof["weights_read_bound_ms"]})
    return rows


def arch_kimi_hd112(torch, dev) -> list:
    """kimi-k2 at full width (d 7168, 64/8 heads, head dim 112, 384
    experts top-8, vocab 163840) cut to 1 of its 61 layers (33.8 GB of
    experts), behind a one-model MLP router: PROMPTS through the paged
    engine, and 4 of them per call. Its attention is the decode kernels at
    hd 112 and g 8, the padded build: the counters show #3 on the engine
    path and #2 on the per-call path. Then its decode step against its
    weight-read bound."""
    from repro_torch import routers
    from repro_torch.config import RouterConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serve.gateway import RoutedServer, make_pool_model
    gen = torch.Generator(device=dev).manual_seed(6)
    t0 = time.perf_counter()
    cfg = _cut(get_config("kimi-k2-1t-a32b"), 1)
    pool = [make_pool_model(cfg.name, cfg, 1.0, gen=gen, device=dev)]
    router = routers.make("mlp", RouterConfig(num_models=1)).init(gen,
                                                                  device=dev)
    srv = RoutedServer(pool, router, device=dev)
    torch.cuda.synchronize()
    _arch_pool_row(torch, dev, pool, t0)
    for kw in ({}, {"engine": False}):         # warm-up, uncounted
        check_result(srv.generate(PROMPTS[:2], max_new_tokens=MAX_NEW, **kw),
                     pool, 2)
    UA, PA, RU = "decode_attention", "paged_decode_attention", "router_utility"
    others = ("kmeans_assign", "kmeans_assign_reduce", "flash_attention")

    def gen_fn(prompts, **kw):
        def fn():
            out = srv.generate(prompts, max_new_tokens=MAX_NEW, **kw)
            return check_result(out, pool, len(prompts))
        return fn

    rows = [run_path(torch, ops, "kimi-k2 hd 112 generate (engine)",
                     gen_fn(PROMPTS), {RU: 1, PA: None}, (UA,) + others),
            run_path(torch, ops, "kimi-k2 hd 112 generate engine=False",
                     gen_fn(PROMPTS[:4], engine=False), {RU: 1, UA: None},
                     (PA,) + others)]
    prof = profile_moe_decode(torch, srv, 0)
    emit({"phase": "arch_kimi_hd112", "hd": cfg.head_dim, "g": cfg.q_per_kv,
          "launches": {r["path"]: r["launches"] for r in rows},
          "tok_per_s": {r["path"]: r["tok_per_s"] for r in rows},
          "decode_step_ms": prof["step_ms_bare"],
          "weights_read_bound_ms": prof["weights_read_bound_ms"]})
    return rows


REDUCED_ARCHS = ("jamba-1.5-large-398b", "phi3.5-moe-42b-a6.6b",
                 "kimi-k2-1t-a32b", "mamba2-370m", "internvl2-2b")


def _token_by_token(torch, mdl, pm, toks, max_new: int):
    """Greedy tokens of feeding the prompt one token at a time from an
    empty contiguous cache, then continuing: (B, max_new) int32."""
    B, S = toks.shape
    cache = mdl.init_decode_cache(pm.cfg, B, S + max_new,
                                  device=toks.device)
    tok, out = toks[:, :1], []
    for t in range(S + max_new - 1):
        logits, cache = mdl.decode_step(pm.params, cache, pm.cfg, tokens=tok,
                                        pos=t)
        nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        if t >= S - 1:
            out.append(nxt[:, 0])
        tok = toks[:, t + 1:t + 2] if t + 1 < S else nxt
    return torch.stack(out, dim=1)


def arch_reduced_f32(torch, dev) -> list:
    """Reduced f32 jamba, phi-3.5-MoE, kimi-k2, mamba2-370m and
    internvl2-2b on the card, and hubert's forward: the attention archs'
    engine tokens equal their per-request tokens; the SSM and hybrid
    per-call tokens at prompts of 1 to 5 tokens equal token-by-token
    decode from an empty cache, and the hybrid's attention layer runs #2;
    hubert's logits are finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.gateway import RoutedServer, make_pool_model
    gen = torch.Generator(device=dev).manual_seed(7)
    pool = [make_pool_model(a, get_config(a).reduced(), 0.1, gen=gen,
                            device=dev) for a in REDUCED_ARCHS]
    eng = ServeEngine(pool, device=dev)
    hub_cfg = get_config("hubert-xlarge").reduced()
    hub = mdl.init_params(gen, hub_cfg, device=dev)
    UA, PA = "decode_attention", "paged_decode_attention"
    res = {}

    def fn():
        n = 0
        for m, pm in enumerate(pool):
            if pm.cfg.arch_type in ("ssm", "hybrid"):
                before = ops.launch_counts()[UA]
                for S in range(1, 6):
                    toks = torch.randint(1, pm.cfg.vocab, (2, S),
                                         generator=gen, device=dev).int()
                    got = RoutedServer._serve_batch(pm, toks.cpu().numpy(),
                                                    MAX_NEW)
                    want = _token_by_token(torch, mdl, pm, toks, MAX_NEW)
                    if (got != want.cpu().numpy()).any():
                        raise AssertionError(f"{pm.name} S={S}: per-call "
                                             "tokens differ from token-by-"
                                             "token decode")
                    n += got.size
                hyb = ops.launch_counts()[UA] - before
                if (pm.cfg.arch_type == "hybrid") != (hyb > 0):
                    raise AssertionError(f"{pm.name}: {hyb} launches of "
                                         f"{UA}")
                res[pm.name] = {"per_call_equals_token_by_token": True,
                                "prompt_lens": [1, 2, 3, 4, 5],
                                UA: hyb}
                continue
            toks = [RoutedServer._tokenize([p], pm.cfg, None)[0]
                    for p in PROMPTS]
            rids = [eng.submit(m, t, MAX_NEW) for t in toks]
            done = eng.drain(rids)
            for t, r in zip(toks, rids):
                solo = RoutedServer._serve_batch(pm, t[None], MAX_NEW)[0]
                if list(done[r]) != list(solo):
                    raise AssertionError(f"{pm.name}: engine {done[r]} vs "
                                         f"per-request {solo}")
                n += len(solo)
            res[pm.name] = {"engine_equals_per_request": True,
                            "prompts": len(PROMPTS)}
        emb = torch.randn((2, 24, hub_cfg.d_model), generator=gen, device=dev)
        logits, _ = mdl.forward(hub, hub_cfg, embeds=emb)
        if logits.shape != (2, 24, hub_cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("hubert: bad logits")
        res[hub_cfg.name] = {"logits": list(logits.shape), "finite": True}
        return n

    row = run_path(torch, ops, "arch reduced f32", fn, {UA: None, PA: None},
                   ("router_utility", "kmeans_assign", "kmeans_assign_reduce",
                    "flash_attention"))
    emit({"phase": "arch_reduced_f32", "models": res})
    return [row]


# ---------------------------------------------------------------------------
# Slice 11: LM training and its drivers, the RouterBench harness
# ---------------------------------------------------------------------------

#: where the LM phases write their checkpoints (inside the checkout,
#: removed after each phase)
SCRATCH = ROOT / ".chip_smoke_tmp"
TRAIN_LM_STEPS = 30      # train_lm's own default is 300


class _Stamps:
    """A stdout that passes every line through and keeps the host clock
    at which each line ended: the per-step times of ``train_loop``, whose
    ``float(loss)`` waits for the device at every step."""

    def __init__(self, out):
        self.out, self.lines, self._buf = out, [], ""

    def write(self, s: str) -> int:
        self.out.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)

    def flush(self) -> None:
        self.out.flush()


def _stamped(fn):
    """(fn's result, [(host time, line), ...] of what it printed)."""
    import contextlib
    st = _Stamps(sys.stdout)
    with contextlib.redirect_stdout(st):
        out = fn()
    return out, st.lines


def _step_times(t0: float, lines) -> list:
    """Seconds of each training step, from the stamps of its log lines."""
    ts = [t for t, ln in lines if ln.startswith("step ")]
    return [b - a for a, b in zip([t0] + ts[:-1], ts)]


def lm_train_full_width(torch, dev) -> tuple:
    """``launch.train.train_loop`` on qwen2-1.5b at full width (28 layers,
    bf16, vocab 151,936; the data vocabulary capped at 8,192 as in the
    reference), batch 8 × seq 256, 4 steps, checkpoint at the end: the
    losses are finite, the restored parameters equal the trained ones bit
    for bit, and earlier phases must hold less than one qwen2-1.5b's
    weights when it begins (the served pool is freed). Prints seconds per
    step, tokens/s, the peak memory and what was held. The training path runs no kernel of the port (prefill attention is the
    plain ``chunked_attention``, as in the reference). Returns (rows, the
    step's measured seconds and peak memory for ``accounting_train``)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_loop
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optim import tree_leaves
    cfg = get_config("qwen2-1.5b")
    steps, batch, seq = 4, 8, 256
    path = SCRATCH / "qwen2_1_5b.msgpack"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # what earlier phases still hold
    if held >= 2 * 1_777_088_000:
        raise AssertionError(f"lm_train_full_width: earlier phases still "
                             f"hold {held} bytes, a served model's worth")
    t0 = time.perf_counter()
    ((params, hist), lines), row = run_fit(
        torch, ops, "lm_train_full_width",
        lambda: _stamped(lambda: train_loop(
            cfg, steps=steps, batch=batch, seq=seq, lr=3e-4, seed=0,
            log_every=1, ckpt_path=path, device=dev)), {}, phase="lm")
    peak = torch.cuda.max_memory_allocated()
    per_step = _step_times(t0, lines)
    save_s = lines[-1][0] - [t for t, ln in lines
                             if ln.startswith("step ")][-1]
    if len(hist) != steps or not all(math.isfinite(v) for v in hist):
        raise AssertionError(f"lm_train_full_width: losses {hist}")
    t1 = time.perf_counter()
    blob = ckpt.restore(path, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    got, want = tree_leaves(blob["params"]), tree_leaves(params)
    if blob["step"] != steps or len(got) != len(want) or not all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, want)):
        raise AssertionError("lm_train_full_width: the restored checkpoint "
                             "differs from the trained parameters")
    nbytes = path.stat().st_size
    n_params = sum(t.numel() for t in want)
    del blob, got, want, params
    shutil.rmtree(SCRATCH, ignore_errors=True)
    steady = statistics.median(per_step[1:])
    emit({"phase": "lm_train_full_width", "arch": cfg.name,
          "layers": cfg.n_layers,
          "params": n_params, "dtype": cfg.dtype, "batch": batch, "seq": seq,
          "losses": hist, "step_seconds": per_step,
          "seconds_per_step": steady, "tokens_per_s": batch * seq / steady,
          "peak_mib": peak / 2 ** 20, "held_before_mib": held / 2 ** 20,
          "peak_above_start_mib": (peak - held) / 2 ** 20,
          "checkpoint_bytes": nbytes,
          "save_seconds": save_s, "restore_seconds": restore_s,
          "round_trip_bit_identical": True})
    return [row], {"batch": batch, "seq": seq, "seconds_per_step": steady,
                   "peak_bytes": peak, "held_bytes": held}


def train_lm_phase(torch, dev) -> list:
    """The ``train_lm`` twin (``CFG_100M``: 12 layers, d 768, ff 3,072,
    vocab 8,192, f32) through its ``main`` at its own batch 16 × seq 512
    and lr 1e-3, ``TRAIN_LM_STEPS`` steps (its default is 300): the last
    loss must be below the first. Prints the losses, seconds per step and
    tokens/s."""
    import shutil
    from repro_torch import train_lm
    from repro_torch.kernels import ops
    path = SCRATCH / "repro_100m.msgpack"
    t0 = time.perf_counter()
    (hist, lines), row = run_fit(
        torch, ops, "train_lm",
        lambda: _stamped(lambda: train_lm.main([
            "--steps", str(TRAIN_LM_STEPS), "--ckpt", str(path)])), {},
        phase="lm")
    per_step = _step_times(t0, lines)
    shutil.rmtree(SCRATCH, ignore_errors=True)
    if not (all(math.isfinite(v) for v in hist) and hist[-1] < hist[0]):
        raise AssertionError(f"train_lm: loss {hist[0]} → {hist[-1]}")
    # the mean step between the second and the last stamped log line (the
    # first window holds the first step's warm-up)
    st = [(int(ln.split()[1]), t) for t, ln in lines if ln.startswith("step ")]
    if len(st) < 3:
        raise AssertionError(f"train_lm: {len(st)} step lines, need 3")
    steady = (st[-1][1] - st[1][1]) / (st[-1][0] - st[1][0])
    emit({"phase": "train_lm", "config": train_lm.CFG_100M.name,
          "steps": len(hist),
          "batch": 16, "seq": 512, "loss_first": hist[0],
          "loss_last": hist[-1], "losses_every_10": hist[::10],
          "log_intervals_s": per_step, "seconds_per_step": steady,
          "tokens_per_s": 16 * 512 / steady})
    return [row]


def lm_serve_full_width(torch, dev) -> list:
    """The ``launch/serve.py`` twin on qwen2-1.5b at full width: batch 4,
    prompt 32, 16 new tokens, through its ``main`` on the card. Every
    decode step runs ``decode_attention`` once per layer (16 × 28 = 448
    launches); tokens lie in the vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = get_config("qwen2-1.5b")
    B, S, T = 4, 32, 16
    out, row = run_fit(
        torch, ops, "lm_serve_full_width",
        lambda: serve.main(["--arch", cfg.name, "--batch", str(B),
                            "--prompt-len", str(S), "--new-tokens", str(T)]),
        {"decode_attention": T * cfg.n_layers}, phase="lm")
    toks = out["tokens"]
    if toks.shape != (B, T + 1) or int(toks.min()) < 0 or int(
            toks.max()) >= cfg.vocab:
        raise AssertionError(f"lm_serve_full_width: tokens {toks.tolist()}")
    emit({"phase": "lm_serve_full_width", "arch": cfg.name, "batch": B,
          "prompt": S, "new_tokens": T,
          "prefill_seconds": out["prefill_s"],
          "decode_seconds": out["decode_s"],
          "decode_tok_per_s": out["tok_per_s"],
          "decode_attention_launches": row["launches"]["decode_attention"]})
    return [row]


RB_FULL = dict(rcfg=dict(d_emb=24, num_models=8, hidden=(48, 48),
                         dropout=0.0, k_local=6, k_global=10, mf_rank=16),
               fcfg=dict(num_clients=6, rounds=40, batch_size=32, lr=3e-3,
                         seed=0),
               corpus=dict(n_models=8, n_queries=1200, d_emb=24, n_tasks=6),
               local_steps=25)     # bench_routerbench's own: 300
RB_SMOKE = dict(rcfg=dict(d_emb=16, num_models=6, hidden=(48, 48),
                          dropout=0.0, k_local=5, k_global=8, mf_rank=12),
                fcfg=dict(num_clients=4, rounds=30, batch_size=32, lr=3e-3,
                          seed=0),
                corpus=dict(n_models=6, n_queries=800, d_emb=16, n_tasks=5),
                local_steps=200)
RB_ONLINE = dict(n_clients=4, n_models=3, d_emb=24, n_queries=800,
                 queries_per_phase=96, phases=2, embed_sigma=0.9,
                 test_queries=48, seed=0)
RB_ONLINE_STEPS = 50     # bench_routerbench's own: 150
RB_WIDE_STEPS = 25       # the §1-width run's (the harness's own: 400)
#: kernels an offline RouterBench run launches: #1 in the MLP, MF and Elo
#: routes, #4 in K-means' predict and route, #5 in the K-means and Elo fits
RB_KERNELS = ("router_utility", "kmeans_assign", "kmeans_assign_reduce")


def _offline(torch, dev, conf: dict, name: str, **kw) -> tuple:
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.evalbench import make_pool_corpus, offline_routerbench
    from repro_torch.kernels import ops
    corpus = kw.pop("corpus", None)
    if corpus is None:
        corpus = make_pool_corpus(1, device=dev, **conf["corpus"])
    return run_fit(
        torch, ops, name,
        lambda: offline_routerbench(
            0, rcfg=RouterConfig(**conf["rcfg"]),
            fcfg=FedConfig(**conf["fcfg"]), corpus=corpus,
            local_steps=conf["local_steps"], device=dev, **kw),
        dict.fromkeys(RB_KERNELS), phase="routerbench")


def _check_offline(name: str, res: dict) -> None:
    for fam, r in res["families"].items():
        for side in ("federated", "client_local"):
            for sc, v in r[side].items():
                if not 0.0 <= v["aiq"] <= 1.0:
                    raise AssertionError(f"{name}: {fam} {side} {sc} AIQ "
                                         f"{v['aiq']!r}")
        if r["clients_fit"] < 1:
            raise AssertionError(f"{name}: {fam} fitted no client")


def _aiq_table(res: dict) -> dict:
    """{family: {side: {scenario: AIQ}}} plus each attack's flip rate."""
    return {fam: {**{side: {sc: v["aiq"] for sc, v in r[side].items()}
                     for side in ("federated", "client_local")},
                  "flip_rate": r["federated"]["adversarial"]["flip_rate"],
                  "clients_fit": r["clients_fit"]}
            for fam, r in res["families"].items()}


def routerbench_reference_scale(torch, dev) -> list:
    """``bench_routerbench`` on the card. Its full configuration
    (``benchmarks/perf_suite.py:992-998``: 8 models, 1,200 queries, d_emb
    24, 6 clients, 40 rounds; all four families; its 300 local steps cut
    to 25) offline, and online for "mf" and "elo" (``:1015-1022``; its
    150 local steps cut to 50); each AIQ printed beside
    ``BENCH_routerbench.json``'s (JAX on a CPU, read as data: a
    comparison, not a check). Its smoke configuration (``:984-990``)
    offline twice: the two dicts must be equal, and the reference's CI
    floor must hold — federated AIQ ≥ client-local AIQ for "mf" in every
    scenario."""
    from repro_torch.evalbench import online_routerbench
    from repro_torch.fed import ScenarioConfig
    from repro_torch.kernels import ops
    ref = json.loads((ROOT / "BENCH_routerbench.json").read_text())["meta"]
    rows = []
    full, row = _offline(torch, dev, RB_FULL, "routerbench full config")
    rows.append(row)
    _check_offline("routerbench full config", full)
    online = {}
    for fam in ("mf", "elo"):
        # Elo's fit clusters the queries (#4, #5); MF's launches neither
        owns = {"router_utility": None, "paged_decode_attention": None,
                **({"kmeans_assign": None, "kmeans_assign_reduce": None}
                   if fam == "elo" else {})}
        res, row = run_fit(
            torch, ops, f"routerbench online {fam}",
            lambda: online_routerbench(
                family=fam, cfg=ScenarioConfig(**RB_ONLINE),
                local_steps=RB_ONLINE_STEPS, capacity=256, device=dev),
            owns, phase="routerbench")
        rows.append(row)
        _check_online(f"routerbench online {fam}", res)
        online[fam] = {k: res[k] for k in (
            "auc_online_final", "auc_frozen_local_final", "auc_gap_final",
            "syncs", "requests_served")}
        online[fam]["seconds"] = row["seconds"]
    smoke = []
    for i in (1, 2):
        res, row = _offline(torch, dev, RB_SMOKE,
                            f"routerbench smoke config run {i}")
        rows.append(row)
        smoke.append(res)
    if smoke[0] != smoke[1]:
        raise AssertionError("routerbench smoke config: a second run "
                             "returned another dict")
    _check_offline("routerbench smoke config", smoke[0])
    mf = smoke[0]["families"]["mf"]
    floor = {sc: (mf["federated"][sc]["aiq"], mf["client_local"][sc]["aiq"])
             for sc in ("clean", "paraphrase", "adversarial")}
    emit({"phase": "routerbench_reference_scale",
          "full": {"aiq": _aiq_table(full),
                   "reference": {k: v for k, v in full["reference"].items()
                                 if k != "models"},
                   "seconds": rows[0]["seconds"],
                   "bench_routerbench_json": {
                       "aiq": _aiq_table(ref),
                       "reference": ref["reference"],
                       "offline_wall_seconds": ref["offline_wall_seconds"]}},
          "online": online,
          "bench_routerbench_json_online": ref["online"],
          "smoke": {"aiq": _aiq_table(smoke[0]), "same_dict_twice": True,
                    "mf_fed_vs_local": floor,
                    "seconds": [r["seconds"] for r in rows[-2:]]}})
    for sc, (fed, loc) in floor.items():
        if not fed >= loc:
            raise AssertionError(f"routerbench smoke config: mf {sc} "
                                 f"federated AIQ {fed!r} < client-local "
                                 f"{loc!r}")
    return rows


def routerbench_full_width(torch, dev, corpus) -> list:
    """``offline_routerbench`` on the §1 corpus (36,000 queries, 11 models,
    d_emb 768, ``FedConfig()``: 10 clients, 30 rounds; ``RB_WIDE_STEPS``
    local steps, cut from the harness's 400 for the script's time),
    all four families. Prints every AIQ, the #1, #4 and #5 launches, and
    the adversarial step's peak memory above what was allocated when it
    began: the donor search's (2,048, 9,005) float64 blocks, where the
    reference's (Q, Q, d) difference tensor would take
    9,005² × 768 × 8 bytes ≈ 498 GB."""
    from repro_torch.evalbench import harness
    attack = harness.adversarial_queries
    peaks = []

    def measured(router, x, lam, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = attack(router, x, lam, **kw)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base,
                      tuple(x.shape)))
        return out
    harness.adversarial_queries = measured
    try:
        res, row = _offline(torch, dev, {"rcfg": {}, "fcfg": {},
                                         "local_steps": RB_WIDE_STEPS},
                            "routerbench full width", corpus=corpus)
    finally:
        harness.adversarial_queries = attack
    _check_offline("routerbench full width", res)
    Q, d = peaks[0][1]
    qqd = Q * Q * d * 8
    worst = max(p for p, _ in peaks)
    if worst >= qqd / 100:
        raise AssertionError(f"routerbench full width: an attack took "
                             f"{worst} bytes")
    emit({"phase": "routerbench_full_width", "test_rows": Q,
          "d_emb": d, "aiq": _aiq_table(res),
          "reference": {k: v for k, v in res["reference"].items()
                        if k != "models"},
          "attacks": len(peaks), "attack_peak_mib": worst / 2 ** 20,
          "qqd_tensor_gib": qqd / 2 ** 30,
          "launches_1_4_5": {k: row["launches"][k] for k in RB_KERNELS}})
    return [row]


# ---------------------------------------------------------------------------
# Step accounting and the clients mesh
# ---------------------------------------------------------------------------

#: the dry-run's combos on the card's host: every arch at one shape, and
#: qwen2-1.5b (the trained and served model) at all four
ACCOUNTING_COMBOS = ([(a, "decode_32k") for a in (
    "hubert-xlarge", "internvl2-2b", "jamba-1.5-large-398b",
    "kimi-k2-1t-a32b", "mamba2-370m", "phi3.5-moe-42b-a6.6b", "qwen2-1.5b",
    "qwen3-8b", "yi-34b", "yi-6b")]
    + [("qwen2-1.5b", s) for s in ("train_4k", "prefill_32k", "long_500k")])
DECODE_SLOTS, DECODE_CACHE = 8, 4096


def accounting_start() -> tuple:
    """Start ``launch/dryrun.py`` on the meta device (no GPU) for every arch
    at decode_32k and qwen2-1.5b at all four input shapes, in a child
    process: host work only, so it overlaps the card's phases until
    ``accounting`` reads it. Returns (the process, its JSONL path, the
    host clock at its start); an exit handler stops it if the script ends
    first."""
    import atexit
    SCRATCH.mkdir(exist_ok=True)
    path = SCRATCH / "dryrun_torch.jsonl"
    path.unlink(missing_ok=True)
    code = ("import pathlib, sys; sys.path.insert(0, 'src'); "
            "from repro_torch.launch import dryrun; "
            f"dryrun.run_all({ACCOUNTING_COMBOS!r}, "
            f"path=pathlib.Path({str(path)!r}), verbose=False)")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path, time.perf_counter()


def accounting(started: tuple) -> dict:
    """Wait for ``accounting_start``'s dry-run and print each row's counts,
    the ok / skipped / error tally (no error allowed), the seconds the
    rows took and the wall time from its start. Returns the records by
    (arch, shape)."""
    proc, path, t0 = started
    _, err = proc.communicate(timeout=600)
    if proc.returncode:
        raise AssertionError(f"accounting: the dry-run exited "
                             f"{proc.returncode}: {err[-3000:]}")
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    keys = ("arch", "shape", "status", "reason", "n_params", "n_active",
            "model_flops", "counted_flops", "useful_flops_ratio", "op_bytes",
            "min_bytes", "state_bytes_global", "fits", "compute_s",
            "memory_s", "dominant", "seconds", "error")
    for r in recs:
        emit({"phase": "accounting", **{k: r[k] for k in keys if k in r}})
    tally = {st: sum(r["status"] == st for r in recs)
             for st in ("ok", "skipped", "error")}
    emit({"phase": "accounting_done", "tally": tally,
          "seconds": sum(r["seconds"] for r in recs),
          "wall_since_start": time.perf_counter() - t0})
    if len(recs) != len(ACCOUNTING_COMBOS) or tally["error"] \
            or tally["skipped"] != 1:
        raise AssertionError(f"accounting: {len(recs)} rows, {tally}")
    return {(r["arch"], r["shape"]): r for r in recs}


def accounting_decode(torch, dev, pool, prof: dict) -> list:
    """One ``make_decode_step`` of each served model (qwen2-1.5b, yi-6b;
    its weights on the card) at 8 slots over a 4,096-position cache, under
    ``OpCosts``: its FLOPs, bytes and kernel calls equal the meta count of
    the same shapes, and #2 launches once per layer (counted by formula).
    The served pair's weight-read term (``chunk`` decode steps of every
    weight, the data sheet's HBM rate) equals ``profile``'s
    ``weights_read_bound_ms``. Returns a row per decode step with its
    launch counts."""
    from repro_torch.config import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import device_peaks
    from repro_torch.launch.op_analysis import roofline_terms
    from repro_torch.models import model as mdl
    shape = InputShape("served", DECODE_CACHE, DECODE_SLOTS, "decode")
    one = {"data": 1, "model": 1}
    wbytes, rows = 0, []
    for pm in pool:
        cfg = pm.cfg
        inputs = {"cache": mdl.init_decode_cache(cfg, DECODE_SLOTS,
                                                 DECODE_CACHE, device=dev),
                  "tokens": torch.zeros((DECODE_SLOTS, 1), dtype=torch.int32,
                                        device=dev),
                  "pos": torch.tensor(100, dtype=torch.int32, device=dev)}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        card, _ = dryrun.count_step(cfg, shape, pm.params, inputs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = ops.launch_counts()
        params = dryrun.abstract_params(cfg)
        meta, _ = dryrun.count_step(cfg, shape, params,
                                    SP.input_shapes(cfg, shape, one)[0])
        wbytes += dryrun.tree_bytes(params)
        rows.append({"phase": "accounting_card", "part": "decode",
                     "path": f"accounting_card decode {cfg.name}",
                     "slots": DECODE_SLOTS, "cache": DECODE_CACHE,
                     "card": card.totals(), "meta": meta.totals(),
                     "kernels": card.kernels, "launches": launches,
                     "seconds": dt})
        emit(rows[-1])
        del inputs
        if card.totals() != meta.totals() or card.kernels != meta.kernels:
            raise AssertionError(f"accounting_card {cfg.name}: the card "
                                 "counts another step than the meta device")
        want = {k: (cfg.n_layers if k == "decode_attention" else 0)
                for k in launches}
        if launches != want or card.kernels["decode_attention"]["calls"] \
                != cfg.n_layers:
            raise AssertionError(f"accounting_card {cfg.name}: launches "
                                 f"{launches}, kernels {card.kernels}")
    chunk = prof["decode_steps"] // 2
    term = roofline_terms({"flops": 0, "op_bytes": chunk * wbytes},
                          device_peaks(torch.cuda.get_device_name(0)),
                          "bfloat16")["memory_s"] * 1e3
    emit({"phase": "accounting_card", "part": "weight_read",
          "weights_bytes": wbytes, "decode_steps": chunk,
          "memory_term_ms": term,
          "profile_weights_read_bound_ms": prof["weights_read_bound_ms"]})
    if term != prof["weights_read_bound_ms"]:
        raise AssertionError("accounting_card: the weight-read term differs "
                             "from profile's bound")
    return rows


def accounting_train(torch, lm: dict, smi: str) -> None:
    """The qwen2-1.5b train step that ``lm_train_full_width`` timed (batch
    8 × seq 256), counted on the meta device: its FLOPs, ``model_flops``,
    the MFU (counted FLOPs over the measured step seconds times the bf16
    peak of the card's data sheet), ``min_bytes`` and the state bytes
    beside the measured peak memory."""
    from repro_torch.config import InputShape
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import device_peaks
    from repro_torch.models import model as mdl
    cfg = get_config("qwen2-1.5b")
    shape = InputShape("lm_train", lm["seq"], lm["batch"], "train")
    params = dryrun.abstract_params(cfg)
    inputs = SP.input_shapes(cfg, shape, {"data": 1, "model": 1})[0]
    costs, opt = dryrun.count_step(cfg, shape, params, inputs)
    peaks = device_peaks(torch.cuda.get_device_name(0))
    n_active = mdl.active_param_count(params, cfg)
    state = dryrun.tree_bytes(params) + dryrun.tree_bytes(opt.m) \
        + dryrun.tree_bytes(opt.v)
    emit({"phase": "accounting_card", "part": "train", "arch": cfg.name,
          "gpu": smi, "batch": lm["batch"], "seq": lm["seq"],
          "counted_flops": costs.flops,
          "model_flops": 6 * n_active * lm["batch"] * lm["seq"],
          "seconds_per_step": lm["seconds_per_step"],
          "mfu": costs.flops / (lm["seconds_per_step"]
                                * peaks["flops"]["bfloat16"]),
          "op_bytes": costs.op_bytes,
          "min_bytes": dryrun.min_bytes(cfg, shape, params, inputs, opt),
          "state_bytes": state,
          "state_and_grad_bytes": state + dryrun.tree_bytes(params),
          "peak_bytes_measured": lm["peak_bytes"],
          "held_before_bytes": lm["held_bytes"]})


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def clients_mesh(torch, dev, split, fitted: dict, fit_rows: list) -> list:
    """The §1-width MLP and K-means federated fits (``FedConfig()``, the
    seeds of ``fit_phase``) through ``fit_federated(mesh=client_mesh())``
    on a one-process nccl group, the slab placed by ``shard_clients``:
    both equal ``fit_phase``'s in-process fits bit for bit (state and the
    loss history's ends), the K-means fit launches #4 and #5 as in
    process, the fitted routers' AUCs on the global test split equal the
    in-process ones (scoring runs #4 for K-means; a route bucket #1 for
    the MLP, #4 for K-means), and the all-gathers that ``OpCosts`` counts
    in one round (the K-means fit: once) move exactly the analytic bytes.
    Prints seconds per fit beside the in-process fit's."""
    import torch.distributed as dist
    from repro_torch import routers, sharding as shd
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.core import policy
    from repro_torch.kernels import ops
    from repro_torch.launch.op_analysis import OpCosts
    from repro_torch.train.optim import tree_leaves
    rcfg, fcfg = RouterConfig(), FedConfig()
    KA, KR, RU = "kmeans_assign", "kmeans_assign_reduce", "router_utility"
    tg = split["test_global"]
    secs = {r["path"]: r["seconds"] for r in fit_rows}
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    rows = []
    try:
        mesh = shd.client_mesh()
        data = shd.shard_clients(split["train"], mesh)
        N, D, d = split["train"]["x"].shape
        n_active = max(1, int(round(fcfg.participation * N)))
        for fam, seed, owns in (
                ("mlp", 30, {}),
                ("kmeans", 31, {KR: 2 * rcfg.kmeans_iters, KA: 3})):
            name = f"fed {fam}"

            def fit(rounds=None):
                gen = torch.Generator(device=dev).manual_seed(seed)
                return routers.fit_federated(routers.make(fam, rcfg), data,
                                             fcfg, gen=gen, device=dev,
                                             rounds=rounds, mesh=mesh)
            (router, hist), row = run_fit(torch, ops, f"clients_mesh {fam}",
                                          fit, owns, phase="clients_mesh")
            rows.append(row)
            want = fitted[name]
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(router.state), tree_leaves(want.state)))
            wrow = next(r for r in fit_rows if r["path"] == name)
            if fam == "mlp":
                same &= (hist["loss"][0] == wrow["loss_round1"]
                         and hist["loss"][-1] == wrow["loss_round30"])
            auc, _ = run_fit(torch, ops, f"clients_mesh {fam}: eval_router",
                             lambda: policy.eval_router(
                                 router.predict, tg["x"], tg["acc_table"],
                                 tg["cost_table"])[2],
                             {KA: 1} if fam == "kmeans" else {},
                             phase="clients_mesh")
            _, rrow = run_fit(torch, ops, f"clients_mesh {fam}: route bucket",
                              lambda: router.route(tg["x"][:16], 1.0),
                              {KA: 1} if fam == "kmeans" else {RU: 1},
                              phase="clients_mesh")
            want_auc = next(r["auc"] for r in fit_rows
                            if r["path"] == f"{name}: eval_router (predict)")
            # one round (the K-means fit: the whole fit) counted
            with OpCosts() as oc:
                fit(rounds=1)
            coll = oc.totals()["collectives"]
            if fam == "mlp":
                n_par = sum(t.numel() for t in tree_leaves(router.state))
                analytic = n_active * (n_par + 2) * 4
            else:
                kl, K, M = rcfg.k_local, rcfg.k_global, rcfg.num_models
                analytic = 4 * N * (kl * d + kl + K * M * 3)
            emit({"phase": "clients_mesh", "family": fam, "world": 1,
                  "backend": dist.get_backend(),
                  "bit_identical": same, "auc": auc, "auc_in_process":
                  want_auc, "seconds_mesh": row["seconds"],
                  "seconds_in_process": secs[name],
                  "launches": row["launches"],
                  "collectives_per_round": coll,
                  "all_gather_bytes_analytic": analytic})
            if not same or auc != want_auc:
                raise AssertionError(f"clients_mesh {fam}: the mesh fit "
                                     "differs from the in-process fit")
            if coll != {"all-gather": analytic}:
                raise AssertionError(f"clients_mesh {fam}: collectives "
                                     f"{coll}, expected {analytic} bytes "
                                     "of all-gather")
    finally:
        dist.destroy_process_group()
    return rows


#: the serving meshes' MoE check: tokens of the phi-3.5-MoE layer, and
#: the bf16 tolerance of the expert-parallel dispatch against the dense one
#: in bf16 ulps of the dense output's largest magnitude
MOE_TOKENS = 256
MOE_ULPS = 8


def _mesh_serve(srv, lams) -> tuple:
    """``SOLO`` through ``srv.submit`` at the given λs, drained: (tokens
    in submit order, the engine's counters)."""
    rids = [srv.submit(p, lam=lam, max_new_tokens=MAX_NEW)
            for p, lam in zip(SOLO, lams)]
    done = srv.drain(rids)
    return [done[r].tolist() for r in rids], srv.engine.counters()


def _mesh_lanes(torch, dev, ops, pool, router, shd) -> tuple:
    """(a) of ``serving_mesh``: ``SOLO`` on paged and uniform lanes, solo
    and on a ``data`` mesh and a ``data`` × ``heads`` mesh (1 × 1). Each
    server is warmed by one request, then its run is counted. Returns
    (rows, {lane: {mesh: summary}})."""
    from repro_torch.launch.op_analysis import OpCosts
    from repro_torch.serve.engine import EngineConfig
    from repro_torch.serve.gateway import RoutedServer
    RU, UA, PA = "router_utility", "decode_attention", "paged_decode_attention"
    lams = (0.0, 2.0, 0.0, 2.0)
    meshes = (("solo", None), ("data", shd.data_mesh),
              ("data x heads", lambda: shd.make_mesh({"data": 1,
                                                       "heads": 1})))
    rows, out = [], {}
    for lane, ecfg in (("paged", EngineConfig()),
                       ("uniform", EngineConfig(page_size=None))):
        kern = PA if lane == "paged" else UA
        res = out[lane] = {}
        for name, mk in meshes:
            srv = RoutedServer(pool, router, device=dev, engine_cfg=ecfg,
                               mesh=mk() if mk else None)
            srv.drain([srv.submit(SOLO[0], lam=0.0, max_new_tokens=8)])
            (toks, counters), row = run_fit(
                torch, ops, f"serving_mesh {lane} {name}",
                lambda: _mesh_serve(srv, lams), {RU: len(SOLO), kern: None},
                phase="serving_mesh")
            rows.append(row)
            res[name] = {"tokens": toks, "counters": counters,
                         "launches": row["launches"][kern],
                         "seconds": row["seconds"],
                         "lanes": sorted(srv.engine._lanes)}
            if name == "data" and lane == "paged":
                # the collectives of one engine step with both lanes busy
                for p, lam in zip(SOLO, lams):
                    srv.submit(p, lam=lam, max_new_tokens=MAX_NEW)
                srv.step()
                with OpCosts() as oc:
                    srv.step()
                srv.drain()
                res[name]["step_collectives"] = oc.totals()["collectives"]
                res[name]["busy_lanes"] = len(srv.engine._lanes)
            del srv
    return rows, out


def _mesh_spec(torch, dev, ops, pool, shd) -> tuple:
    """(b) of ``serving_mesh``: ``spec_full_width``'s qwen3-8b drafted by
    qwen2-1.5b, solo and on a ``data`` mesh, 8 tokens a prompt (the random
    pair accepts no draft, so each round commits one token)."""
    from repro_torch.serve.engine import EngineConfig
    from repro_torch.serve.gateway import RoutedServer
    UA, PA = "decode_attention", "paged_decode_attention"
    pool3, router3 = _spec_pool(torch, dev, pool, reduced=False)
    rows, res = [], {}
    for name, mesh in (("solo", None), ("data", shd.data_mesh())):
        srv = RoutedServer(pool3, router3, device=dev, mesh=mesh,
                           engine_cfg=EngineConfig(spec_k=SPEC_K))
        _lane_run(srv.engine, pool3, 2, draft=0, n=1, max_new=4)   # warm-up
        (toks, c), row = run_fit(
            torch, ops, f"serving_mesh spec qwen3-8b <- qwen2-1.5b {name}",
            lambda: _lane_run(srv.engine, pool3, 2, draft=0, max_new=8),
            {UA: None, PA: None}, phase="serving_mesh")
        rows.append(row)
        res[name] = {"tokens": [t.tolist() for t in toks], "counters": c,
                     "launches": {k: row["launches"][k] for k in (UA, PA)},
                     "seconds": row["seconds"]}
        del srv
    return rows, res


def _mesh_loop(torch, dev, ops, pool, shd) -> tuple:
    """(c) of ``serving_mesh``: ``fedloop_full_width``'s configuration (the
    MLP ``pool_router``, d_emb 768, 4 clients) over the first 4 arrivals of
    its phase 0, then one sync: in process, and with the engine on
    ``data_mesh()`` and the sync on ``client_mesh()``; then the mesh loop
    saved and restored into a fresh mesh loop."""
    import copy
    import tempfile

    import numpy as np

    from repro_torch.config import FedConfig
    from repro_torch.fed import (FedLoop, FedLoopConfig, HarvestStore,
                                 ScenarioConfig, TrafficScenario)
    from repro_torch.serve.gateway import RoutedServer
    from repro_torch.train.optim import tree_leaves
    RU, PA = "router_utility", "paged_decode_attention"
    router = pool_router(torch, dev, "mlp")
    scen = TrafficScenario(ScenarioConfig(**FEDLOOP_SCENARIO))
    events = scen.events(0)[:4]
    rng0 = copy.deepcopy(scen._outcome_rng)
    fcfg = FedConfig(num_clients=4, participation=0.75, batch_size=32,
                     lr=3e-3)

    def make(mesh=None, engine_mesh=None):
        srv = RoutedServer(pool, router, device=dev, mesh=engine_mesh,
                           harvest=HarvestStore(768, capacity=64,
                                                clients=range(4), device=dev))
        return FedLoop(srv, fcfg, gen=31, cfg=FedLoopConfig(
            sync_every=8, rounds_per_sync=4, min_samples=16, mesh=mesh))

    def drive(loop):
        scen._outcome_rng = copy.deepcopy(rng0)
        srv = loop.server
        for c, q, lam in events:
            rid = srv.submit(scen.prompt(q), lam=lam,
                             max_new_tokens=scen.cfg.max_new, client_id=c,
                             x=scen.x(q, 0))
            srv.report_outcome(rid, *scen.observe(q, srv.routed_model(rid)))
            loop.step()
        loop.drain()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop.sync()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    rows, res = [], {}
    loops = {"in_process": make(),
             "mesh": make(shd.client_mesh(), shd.data_mesh())}
    for name, loop in loops.items():
        sync_s, row = run_fit(torch, ops, f"serving_mesh fedloop {name}",
                              lambda: drive(loop),
                              {RU: len(events), PA: None},
                              phase="serving_mesh")
        rows.append(row)
        res[name] = {"seconds": row["seconds"], "sync_seconds": sync_s}
    a, m = (loops[k] for k in ("in_process", "mesh"))
    la, lm = (tree_leaves(x.server.router.state) for x in (a, m))
    same = (len(la) == len(lm) and all(torch.equal(x, y)
                                       for x, y in zip(la, lm))
            and [h["loss"] for h in a.history] == [h["loss"]
                                                   for h in m.history])
    tmp = tempfile.TemporaryDirectory()
    path = Path(tmp.name) / "fedloop.ckpt"
    t0 = time.perf_counter()
    m.save(path)
    res["save_seconds"] = time.perf_counter() - t0
    res["checkpoint_bytes"] = path.stat().st_size
    r = make(shd.client_mesh(), shd.data_mesh())
    t0 = time.perf_counter()
    r.restore(path)
    res["restore_seconds"] = time.perf_counter() - t0
    tmp.cleanup()
    lr_ = tree_leaves(r.server.router.state)
    hm, hr = m.server.harvest.state(), r.server.harvest.state()
    round_trip = (all(torch.equal(x, y) for x, y in zip(lm, lr_))
                  and r.history == m.history
                  and r.server.router_version == m.server.router_version
                  and [c for c, _ in hm["clients"]]
                  == [c for c, _ in hr["clients"]]
                  and all(np.array_equal(x[k], y[k]) for (_, x), (_, y)
                          in zip(hm["clients"], hr["clients"]) for k in x))
    res.update(bit_identical=same, round_trip=round_trip,
               syncs=[len(x.history) for x in (a, m)])
    return rows, res


def _mesh_moe(torch, dev, shd) -> dict:
    """(d) of ``serving_mesh``: one phi-3.5-MoE layer at full width (16
    experts, top 2, bf16) on ``MOE_TOKENS`` tokens through
    ``_capacity_shard_map`` under {"tokens": "data", "experts": "model"}
    on a 1 × 1 mesh: at cf 1.25 against ``_capacity_dispatch`` (output and
    aux loss bit for bit: see the check), at cf 8.0 against the dense
    dispatch within ``MOE_ULPS`` bf16 ulps of its largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    gen = torch.Generator(device=dev).manual_seed(5)
    p = M.init_moe(gen, cfg)
    x = torch.randn((MOE_TOKENS, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    mesh = shd.make_mesh({"data": 1, "model": 1})
    rules = {"tokens": "data", "experts": "model"}

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    tw, ti, probs = M._router_probs(p, x, cfg)
    aux_want = M._aux_loss(probs, ti, cfg)
    (want, _), _ = run(lambda: (M._capacity_dispatch(p, x, tw, ti, cfg,
                                                     1.25), 0))
    (want, _), cap_s = run(lambda: (M._capacity_dispatch(p, x, tw, ti, cfg,
                                                         1.25), 0))
    with shd.use_rules(mesh, rules):
        run(lambda: M._capacity_shard_map(p, x, cfg, 1.25))      # warm-up
        (got, aux), map_s = run(lambda: M._capacity_shard_map(p, x, cfg,
                                                              1.25))
        (got8, aux8), _ = run(lambda: M._capacity_shard_map(p, x, cfg, 8.0))
    dense = M._dense_dispatch(p, x, tw, ti, cfg)
    # index_add_ adds with atomics on the card, in no fixed order; a token
    # takes at most top_k = 2 expert outputs, and 0 + a + b rounds as
    # 0 + b + a (two-term float addition commutes), so the order cannot
    # show: the dispatch must equal _capacity_dispatch bit for bit
    C = max(1, int(MOE_TOKENS * cfg.moe.top_k * 1.25) // cfg.moe.num_experts)
    kept = int(torch.bincount(ti.reshape(-1),
                              minlength=cfg.moe.num_experts).clamp(max=C)
               .sum())
    err = float((got8.float() - dense.float()).abs().max())
    tol = MOE_ULPS * float(bf16_ulp(torch, dense.float().abs().max()))
    return {"tokens": MOE_TOKENS, "experts": cfg.moe.num_experts,
            "top_k": cfg.moe.top_k, "capacity_at_1.25": C,
            "kept_at_1.25": kept, "dropped_at_1.25":
            MOE_TOKENS * cfg.moe.top_k - kept,
            "equal_capacity_dispatch": bool(torch.equal(got, want)),
            "equal_aux": bool(torch.equal(aux, aux_want)),
            "aux_at_8": float(aux8), "dense_max_abs_err": err,
            "dense_tolerance": tol, "dense_err_over_tol": err / tol,
            "shard_map_seconds": map_s, "capacity_dispatch_seconds": cap_s}


def serving_mesh(torch, dev) -> list:
    """The serving meshes on a one-process nccl group of their own, at
    full width: the served pair (qwen2-1.5b and yi-6b, bf16, 8 slots a
    lane, made from ``main_path``'s seed) through ``RoutedServer(mesh=)``
    (a), speculative decode on a data mesh (b), the FedLoop's mesh sync
    (c) and the expert-parallel MoE dispatch (d). Tokens, counters and
    decode launches of every mesh path must equal the solo path's, the
    mesh sync the in-process one bit for bit, and the MoE dispatch its
    references. Prints seconds beside the solo paths."""
    import torch.distributed as dist
    from repro_torch import routers, sharding as shd
    from repro_torch.config import RouterConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serve.gateway import make_pool_model
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        pool = [make_pool_model(a, get_config(a), c, gen=gen, device=dev)
                for a, c in (("qwen2-1.5b", 0.05), ("yi-6b", 0.4))]
        router = routers.make("mlp", RouterConfig(num_models=2)).init(
            gen, device=dev)
        rows, lanes = _mesh_lanes(torch, dev, ops, pool, router, shd)
        spec_rows, spec = _mesh_spec(torch, dev, ops, pool, shd)
        loop_rows, loop = _mesh_loop(torch, dev, ops, pool, shd)
        moe = _mesh_moe(torch, dev, shd)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    rows += spec_rows + loop_rows
    bad = []
    for lane, res in lanes.items():
        solo = res["solo"]
        for name, r in res.items():
            for k in ("tokens", "counters", "launches"):
                if r[k] != solo[k]:
                    bad.append(f"{lane} {name}: {k}")
    for k in ("tokens", "counters", "launches"):
        if spec["data"][k] != spec["solo"][k]:
            bad.append(f"spec data: {k}")
    if not (loop["bit_identical"] and loop["round_trip"]):
        bad.append(f"fedloop: {loop}")
    if not (moe["equal_capacity_dispatch"] and moe["equal_aux"]
            and moe["dense_err_over_tol"] <= 1.0):
        bad.append(f"moe: {moe}")
    chunk_bytes = 8 * (8 + 1) * 4          # slots · (chunk + 1) · int32
    gathered = lanes["paged"]["data"]["step_collectives"]
    if gathered != {"all-gather": chunk_bytes * lanes["paged"]["data"][
            "busy_lanes"]}:
        bad.append(f"step collectives {gathered}")
    emit({"phase": "serving_mesh", "world": 1, "backend": backend,
          "lanes": {lane: {name: {k: r[k] for k in r if k != "tokens"}
                           for name, r in res.items()}
                    for lane, res in lanes.items()},
          "tokens_equal": not any("tokens" in b for b in bad),
          "all_gather_bytes_per_chunk": chunk_bytes,
          "spec": {name: {k: r[k] for k in r if k != "tokens"}
                   for name, r in spec.items()},
          "fedloop": loop, "moe": moe,
          "seconds": time.perf_counter() - t_phase})
    del pool, router
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"serving_mesh: the mesh paths differ from "
                             f"the solo paths in {bad}")
    return rows


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
    data_sheet()                # a card with no data sheet fails here
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import kmeans_assign as km
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

    corpus, split = fit_data(torch, dev)
    t0 = time.perf_counter()
    rows = [kernel_router(torch, ru, dev), *kernel_decode(torch, F, da, dev),
            *kernel_kmeans(torch, F, km, dev, split),
            kernel_flash(torch, F, fa, dev)]
    emit({"phase": "decode_times", "chunk": da._bound().chunk,
          "launch_floor": _launch_floor(torch, dev),
          "shapes": _decode_served(torch, F, da, dev)})
    verify_kernel(torch, dev)
    emit({"phase": "kernels_vs_plain", "seconds": time.perf_counter() - t0})
    new_phases = {}
    # the dry-run is host work on the meta device: it runs beside the
    # serving paths and is read after them
    started = accounting_start()

    t0 = time.perf_counter()
    paths, pool, prof = main_path(torch, dev)
    emit({"phase": "main_path_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    accounting(started)
    new_phases["accounting_wait"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths += accounting_decode(torch, dev, pool, prof)
    new_phases["accounting_card"] = time.perf_counter() - t0
    # the harvest and failover while the full-width pool is loaded
    t0 = time.perf_counter()
    fed_rows, srv_h = harvest_full_width(torch, dev, pool)
    paths += fed_rows
    paths += failover(torch, dev, pool, srv_h.router)
    del srv_h
    emit({"phase": "harvest_failover_done",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    paths += fedloop_full_width(torch, dev, pool)
    emit({"phase": "fedloop_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    paths.append(resilience_full_width(torch, dev, pool))
    paths += spec_full_width(torch, dev, pool)
    del pool
    emit({"phase": "engine_paths_done", "seconds": time.perf_counter() - t0})
    # LM training and its drivers, once the served pool is freed: the
    # engines and servers of the earlier paths hold it through reference
    # cycles until the collector runs
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_rows, lm = lm_train_full_width(torch, dev)
    paths += lm_rows
    paths += train_lm_phase(torch, dev)
    paths += lm_serve_full_width(torch, dev)
    torch.cuda.empty_cache()
    emit({"phase": "lm_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    accounting_train(torch, lm, smi)
    new_phases["accounting_card"] += time.perf_counter() - t0
    paths.append(flash_path(torch, dev))
    t0 = time.perf_counter()
    fit_rows, fitted = fit_phase(torch, dev, split)
    paths += fit_rows
    emit({"phase": "fit_path_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    paths += clients_mesh(torch, dev, split, fitted, fit_rows)
    new_phases["clients_mesh"] = time.perf_counter() - t0
    emit({"phase": "new_phases_seconds", **new_phases,
          "total": sum(new_phases.values())})
    t0 = time.perf_counter()
    paths += serving_mesh(torch, dev)
    emit({"phase": "serving_mesh_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    paths += features_phase(torch, dev, corpus, split, fitted)
    emit({"phase": "features_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    paths += resilience_table(torch, dev, split)
    t1 = time.perf_counter()
    paths += cohort_fit(torch, dev, split)
    emit({"phase": "fed_fits_done", "resilience_seconds": t1 - t0,
          "cohort_seconds": time.perf_counter() - t1})
    t0 = time.perf_counter()
    paths += online_vs_frozen(torch, dev)
    emit({"phase": "online_vs_frozen_done",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    paths += routerbench_reference_scale(torch, dev)
    t1 = time.perf_counter()
    paths += routerbench_full_width(torch, dev, corpus)
    emit({"phase": "routerbench_done", "reference_scale_seconds": t1 - t0,
          "full_width_seconds": time.perf_counter() - t1})
    t0 = time.perf_counter()
    profile_fit(torch, dev, split)
    emit({"phase": "profile_fit_done", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    reduced_parity(torch, dev)
    paths.append(resilience_replay(torch, dev))
    paths += spec_reduced_f32(torch, dev)
    emit({"phase": "reduced_done", "seconds": time.perf_counter() - t0})
    # the full-width MoE loads (~42 and ~39 GB) one at a time, each in a
    # cache emptied of every earlier phase's blocks
    t0 = time.perf_counter()
    for phase in (arch_full_width, arch_kimi_hd112):
        torch.cuda.empty_cache()
        paths += phase(torch, dev)
    paths += arch_reduced_f32(torch, dev)
    emit({"phase": "arch_done", "seconds": time.perf_counter() - t0})

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
    # the interleaved rounds behind ms / library_ms, the spread of their
    # ratio and the device times without host work (router_utility has no
    # library call)
    rounds = ("ms_rounds", "library_rounds", "ratio", "device_ms",
              "library_device_ms")
    print(smi, flush=True)
    emit({"kernels": [{**{k: r[k] for k in keys},
                       **{k: r[k] for k in rounds if k in r}} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
