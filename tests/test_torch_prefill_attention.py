"""Which path prefill attention takes (``models/attention.py``).

``attn_forward`` sends causal, windowless prefill with head dim 64 or 128,
in bf16 or f32, to the ``flash_attention`` kernel when the inputs are on
the card and no gradient is needed; everything else runs the plain
``chunked_attention``. On the CPU the tests make ``resolve_impl`` report
"cuda" and stand the plain version, with a launch counter, in for the
kernel, so the dispatch itself is exercised here; on plain CPU tensors the
output stays bit-equal to ``chunked_attention``'s and nothing launches.

The last test runs only on the card (it skips here): a model with
qwen2-1.5b's head layout (12 query heads, 2 KV heads, hd 128) prefills a
right-padded bucket through the engine once by the kernel and once with
``REPRO_TORCH_KERNELS=ref``. This file imports no JAX.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import model as mdl
from repro_torch.serve import engine

torch.set_num_threads(1)


def _cfg(**kw):
    base = dict(name="prefill-attn", arch_type="dense", n_layers=2,
                d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                head_dim=64, qkv_bias=True, dtype="float32")
    return ModelConfig(**{**base, **kw})


def _launches():
    return kops.launch_counts()["flash_attention"]


@pytest.fixture
def card_standin(monkeypatch):
    """``resolve_impl`` reports "cuda" (the flag still wins when set) and
    the kernel's wrapper runs the plain version, counted like the kernel.
    It takes only what the kernel takes: equal contiguous shapes, hd 64 or
    128, one dtype of f32 and bf16."""
    def resolve(impl, x):
        return impl or os.environ.get("REPRO_TORCH_KERNELS") or "cuda"

    def kernel(q, k, v, *, causal=True):
        assert q.shape == k.shape == v.shape and q.shape[-1] in (64, 128)
        assert q.dtype == k.dtype == v.dtype
        assert q.dtype in (torch.float32, torch.bfloat16)
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        fa.COUNTS["flash_attention"] += 1
        return fa.flash_attention_plain(q, k, v, causal=causal)

    monkeypatch.delenv("REPRO_TORCH_KERNELS", raising=False)
    monkeypatch.setattr(kops, "resolve_impl", resolve)
    monkeypatch.setattr(fa, "flash_attention_cuda", kernel)
    # the stand-in's launches are not the process's: other tests read the
    # counter as the card's
    monkeypatch.setitem(fa.COUNTS, "flash_attention", _launches())
    return monkeypatch


def _layer(cfg, seed=0, B=2, S=48):
    gen = torch.Generator().manual_seed(seed)
    p = A.init_attn(gen, cfg)
    x = torch.randn((B, S, cfg.d_model), generator=gen).to(
        getattr(torch, cfg.dtype))
    return p, x, torch.arange(S)[None, :]


def _plain(p, x, cfg, pos, window=None, layout="grouped"):
    """What ``attn_forward`` computed before the kernel was wired in."""
    q, k, v = A._project_qkv(p, x, cfg, pos)
    win = window if window is not None else (
        cfg.sliding_window if cfg.sliding_window_always else None)
    return A.chunked_attention(q, k, v, causal=cfg.causal, window=win,
                               q_chunk=16, layout=layout) @ p["wo"]


def _kernel(p, x, cfg, pos):
    """The kernel's route with the plain version in its place: each KV head
    repeated to its query heads, query head h reading KV head h // g."""
    q, k, v = A._project_qkv(p, x, cfg, pos)
    g = cfg.n_heads // cfg.n_kv_heads
    att = fa.flash_attention_plain(q, k.repeat_interleave(g, dim=2),
                                   v.repeat_interleave(g, dim=2))
    return att.reshape(*x.shape[:2], -1) @ p["wo"]


def _grad_params(p):
    return {n: t.detach().requires_grad_(True) for n, t in p.items()}


#: (case, config overrides, how the call is made, path expected)
DISPATCH = [
    ("hd 64 under no_grad", {}, "no_grad", "kernel"),
    ("hd 128, no parameter needs a gradient", {"head_dim": 128}, "plain",
     "kernel"),
    ("bf16", {"dtype": "bfloat16"}, "no_grad", "kernel"),
    ("flat layout", {}, "flat", "kernel"),
    ("no GQA: a KV head for each query head", {"n_kv_heads": 4}, "no_grad", "kernel"),
    ("parameters need gradients", {}, "grad", "chunked"),
    ("only wv needs a gradient", {}, "grad_wv", "chunked"),
    ("window passed", {}, "window", "chunked"),
    ("sliding window always", {"sliding_window_always": True,
                               "sliding_window": 16}, "no_grad", "chunked"),
    ("not causal", {"causal": False}, "no_grad", "chunked"),
    ("hd 96", {"head_dim": 96}, "no_grad", "chunked"),
    ("REPRO_TORCH_KERNELS=ref", {}, "ref_flag", "chunked"),
]


@pytest.mark.parametrize("case,over,how,path", DISPATCH,
                         ids=[c[0] for c in DISPATCH])
def test_attn_forward_dispatch(card_standin, case, over, how, path):
    """The kernel is taken once a call exactly when the inputs allow it;
    otherwise ``chunked_attention`` runs as before, and nothing launches.
    Either way the output is the path's own value, bit for bit."""
    cfg = _cfg(**over)
    p, x, pos = _layer(cfg)
    kw = {}
    if how == "flat":
        kw["layout"] = "flat"
    if how == "window":
        kw["window"] = 16
    if how == "ref_flag":
        card_standin.setenv("REPRO_TORCH_KERNELS", "ref")
    if how == "grad":
        p = _grad_params(p)
    if how == "grad_wv":
        p = {**p, "wv": p["wv"].detach().requires_grad_(True)}
    before = _launches()
    if how == "no_grad":
        with torch.no_grad():
            got = A.attn_forward(p, x, cfg, pos, q_chunk=16, **kw)
    else:
        got = A.attn_forward(p, x, cfg, pos, q_chunk=16, **kw)
    if path == "kernel":
        assert _launches() - before == 1
        want = _kernel(p, x, cfg, pos)
    else:
        assert _launches() == before
        want = _plain(p, x, cfg, pos, window=kw.get("window"),
                      layout=kw.get("layout", "grouped"))
    assert got.shape == (*x.shape[:2], cfg.d_model)
    assert torch.equal(got.detach(), want.detach())
    if how.startswith("grad"):
        got.float().square().sum().backward()   # the plain path's backward
        assert p["wv"].grad is not None


@pytest.mark.parametrize("over", [{}, {"head_dim": 128},
                                  {"dtype": "bfloat16"}])
def test_kernel_path_agrees_with_chunked(card_standin, over):
    """On f32 inputs both paths compute the same f32 attention, so the
    kernel's route through the GQA repeat matches ``chunked_attention`` to
    f32 rounding; in bf16 the chunked path rounds p to bf16 before p·v
    and the two sit within a few bf16 steps."""
    cfg = _cfg(**over)
    p, x, pos = _layer(cfg, seed=3)
    with torch.no_grad():
        got = A.attn_forward(p, x, cfg, pos, q_chunk=16).float()
    want = _plain(p, x, cfg, pos).float()
    tol = 2e-5 if cfg.dtype == "float32" else 4e-2
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("over", [{}, {"head_dim": 128},
                                  {"dtype": "bfloat16"}, {"n_kv_heads": 1}])
@pytest.mark.parametrize("layout", ["grouped", "flat"])
def test_cpu_tensors_keep_chunked_attention(monkeypatch, over, layout):
    """With no stand-in, CPU tensors take ``chunked_attention``: the output
    is its own, bit for bit, and no kernel launches."""
    monkeypatch.delenv("REPRO_TORCH_KERNELS", raising=False)
    monkeypatch.setitem(fa.COUNTS, "flash_attention", 0)
    cfg = _cfg(**over)
    p, x, pos = _layer(cfg, seed=1)
    before = _launches()
    with torch.no_grad():
        got = A.attn_forward(p, x, cfg, pos, q_chunk=16, layout=layout)
    assert _launches() == before == 0
    assert torch.equal(got, _plain(p, x, cfg, pos, layout=layout))


def test_unknown_layout_refused_on_either_path(card_standin):
    cfg = _cfg()
    p, x, pos = _layer(cfg)
    with torch.no_grad(), pytest.raises(ValueError, match="layout"):
        A.attn_forward(p, x, cfg, pos, layout="blocked")


def _bucket(cfg, lens, S, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), S), np.int32)       # right-padded rows
    for r, n in enumerate(lens):
        toks[r, :n] = rng.integers(1, cfg.vocab, n)
    return toks, np.asarray(lens, np.int32) - 1


def test_engine_prefill_launches_once_a_layer(card_standin):
    """The engine's coalesced prefill of a right-padded bucket takes the
    kernel once per attention layer; its first layer's K/V (projections
    made before any attention) are the plain path's bit for bit."""
    cfg = _cfg(n_layers=3)
    params = mdl.init_params(torch.Generator().manual_seed(5), cfg,
                             device="cpu")
    toks, last = _bucket(cfg, [32, 19, 5], 32, 5)
    with torch.no_grad():
        before = _launches()
        tok, cache = engine._prefill(cfg, params, toks, last, "cpu")
        assert _launches() - before == cfg.n_layers
        card_standin.setenv("REPRO_TORCH_KERNELS", "ref")
        tok_r, cache_r = engine._prefill(cfg, params, toks, last, "cpu")
        assert _launches() - before == cfg.n_layers
    assert torch.equal(cache["l0"]["k"][0], cache_r["l0"]["k"][0])
    assert torch.equal(cache["l0"]["v"][0], cache_r["l0"]["v"][0])
    assert torch.equal(tok, tok_r)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return torch.device("cuda", 0)


def _bf16_ulp(x):
    ax = x.abs().float().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(ax)) - 7)


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


#: relative norm of the difference between the kernel's and the plain
#: path's last-position logits, and their later layers' K/V. On the CPU at
#: this shape (bf16, three seeds) the kernel's arithmetic in plain PyTorch
#: reads 0.0099–0.0105 on the logits and 0.0071 on layer 1's K/V; q and k
#: rounded to fp8 e4m3 before attention read 0.056 and 0.041, and a wrong
#: GQA head order or a lost causal mask 0.93–1.25.
REL_TOL = 0.02


def test_engine_prefill_by_the_kernel_on_the_card(cuda, monkeypatch):
    """A model of qwen2-1.5b's head layout prefills a right-padded (3, 512)
    bucket with rows of different lengths through ``engine._prefill``, by
    the kernel and with ``REPRO_TORCH_KERNELS=ref``. One launch a layer;
    every launch within chip_smoke.py's tolerance for kernel #6 of its
    plain version on the same inputs (|Δ| ≤ 1 bf16 ulp + 2e-5·A, A the
    attention over |v|); the first layer's K/V bit-equal; the logits and
    later K/V within ``REL_TOL``; the plain path launches nothing."""
    monkeypatch.delenv("REPRO_TORCH_KERNELS", raising=False)
    cfg = ModelConfig(name="qwen2-heads", arch_type="dense", n_layers=2,
                      d_model=1536, n_heads=12, n_kv_heads=2, d_ff=1024,
                      vocab=2048, head_dim=128, qkv_bias=True,
                      rope_theta=1_000_000.0, dtype="bfloat16")
    params = mdl.init_params(torch.Generator(cuda).manual_seed(0), cfg,
                             device=cuda)
    toks, last = _bucket(cfg, [512, 300, 77], 512, 0)
    kernel, worst = fa.flash_attention_cuda, []

    def checked(q, k, v, *, causal=True):
        out = kernel(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal).float()
        A_ = fa.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                      causal=causal)
        d = (out.float() - want).abs()
        worst.append(float((d / (_bf16_ulp(want) + 2e-5 * A_)).max()))
        return out

    monkeypatch.setattr(fa, "flash_attention_cuda", checked)

    def run():
        with torch.no_grad():
            before = _launches()
            tok, cache = engine._prefill(cfg, params, toks, last, cuda)
            logits, _ = mdl.forward(
                params, cfg, tokens=torch.as_tensor(toks, device=cuda),
                logits_last_only=True, last_pos=torch.as_tensor(
                    last, device=cuda), q_chunk=64)
            torch.cuda.synchronize()
        return tok, cache, logits, _launches() - before

    tok, cache, logits, n = run()
    assert n == 2 * cfg.n_layers              # _prefill, then forward
    assert len(worst) == n and max(worst) <= 1.0, worst
    monkeypatch.setenv("REPRO_TORCH_KERNELS", "ref")
    tok_r, cache_r, logits_r, n_r = run()
    assert n_r == 0
    for leaf in ("k", "v"):
        assert torch.equal(cache["l0"][leaf][0], cache_r["l0"][leaf][0])
        assert _rel(cache["l0"][leaf][1], cache_r["l0"][leaf][1]) <= REL_TOL
    assert torch.isfinite(logits.float()).all()
    assert _rel(logits, logits_r) <= REL_TOL
