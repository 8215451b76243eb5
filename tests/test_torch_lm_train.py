"""The port's LM training path on the CPU, against the JAX package.

Weights come from the reference's ``init_params`` through
``repro_torch.convert``; batches from ``MarkovLM`` (numpy, the same draws
in both packages). Held to:

  * ``loss_fn``'s loss (rtol 1e-5) and every gradient leaf equal to
    ``jax.value_and_grad(loss_fn)`` (max |Δ| ≤ 1e-6 + 1e-5 · the leaf's
    largest element: an element that cancels to near zero keeps the f32
    rounding of its larger terms, so an element-wise rtol does not hold
    across frameworks) on reduced f32 dense (qwen2-1.5b), MoE
    (phi-3.5-MoE), SSM (mamba2-370m) and hybrid (jamba) configs, with and
    without a mask;
  * ``remat`` on and off equal bit for bit; ``attn_layout="flat"`` equal to
    ``"grouped"`` (loss to 1e-6, gradients as above: the expanded heads sum
    the same products in another order) and to the reference's flat
    layout;
  * ``cosine_schedule`` to 1e-7 at steps 0 to total + 5, and the
    optimizers' callable ``lr`` (batched clients included);
  * ``MarkovLM`` batches bit-equal over three seeds;
  * five ``make_train_step`` steps: losses to 1e-5 relative; the final
    parameters to 1e-5 relative (atol 1e-7) in all but 0.1% of their
    elements, and every element within 1e-5 relative plus a tenth of one
    step's lr (AdamW's first steps move an element by about lr · sign(g),
    so an element whose gradient is ~0 — the zero-initialised QKV biases
    above all — carries the f32 noise of that sign: measured, 8.8e-6 at
    most, in 18 of 262,144 elements of one leaf);
  * ``make_prefill_step`` / ``make_decode_step`` logits to 1e-4;
  * ``train_loop`` on ``CFG_QUICK`` cut to 2 layers: the loss falls and the
    checkpoint restores bit for bit; the three drivers run with
    ``--device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import model as jmdl
from repro.serve.kv_cache import extend_cache as jextend_cache
from repro.train import optim as joptim
from repro.train.lm_data import MarkovLM as JMarkovLM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as mdl
from repro_torch.serve.kv_cache import extend_cache
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim as toptim
from repro_torch.train.lm_data import MarkovLM
from repro_torch.train.optim import tree_leaves, tree_map

torch.set_num_threads(1)

ARCHS = ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b", "mamba2-370m",
         "jamba-1.5-large-398b"]
B, S = 2, 16
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _leaves(tree):
    return [np.asarray(a) for _, a in
            sorted(jax.tree_util.tree_leaves_with_path(tree),
                   key=lambda kv: jax.tree_util.keystr(kv[0]))]


def _tleaves(tree, prefix=()):
    """The port tree's leaves in the reference's key order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (f"['{k}']",))
        else:
            out.append(("".join(path), t))
    walk(tree, prefix)
    return [t.detach().numpy() for _, t in sorted(out)]


def _assert_leaf_close(got, want, rtol=GRAD_TOL["rtol"],
                       atol=GRAD_TOL["atol"]):
    """max |got − want| ≤ atol + rtol · max |want| over one leaf: the
    rtol is relative to the leaf's scale, because a gradient element that
    cancels to near zero keeps the f32 rounding of its larger terms."""
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= atol + rtol * scale, (err, scale)


def _batch(cfg, seed, mask):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        m = (rng.random((B, S)) < 0.7).astype(np.float32)
        m[:, 0] = 1.0
        b["mask"] = m
    return b


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    jcfg = jget_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jp = jmdl.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")
    return jcfg, cfg, jp, tp


def _port_loss_and_grads(tp, cfg, batch, **kw):
    tp = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    loss = mdl.loss_fn(tp, cfg, {k: torch.as_tensor(v)
                                 for k, v in batch.items()}, **kw)
    grads = iter(torch.autograd.grad(loss, tree_leaves(tp)))
    return loss, tree_map(lambda _: next(grads), tp)


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
def test_loss_and_grads_match_jax(arch_pair, mask):
    jcfg, cfg, jp, tp = arch_pair
    batch = _batch(cfg, 1, mask)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(jmdl.loss_fn)(jp, jcfg, jb, q_chunk=8)
    tl, tg = _port_loss_and_grads(tp, cfg, batch, q_chunk=8)
    np.testing.assert_allclose(float(tl), float(jl), **GRAD_TOL)
    want, got = _leaves(jg), _tleaves(tg)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        _assert_leaf_close(g, w)


def test_remat_and_layouts_agree(arch_pair):
    jcfg, cfg, jp, tp = arch_pair
    batch = _batch(cfg, 2, True)
    base_l, base_g = _port_loss_and_grads(tp, cfg, batch, remat=False)
    for kw in (dict(remat=True), dict(remat=True, attn_layout="flat"),
               dict(remat=False, attn_layout="flat")):
        l, g = _port_loss_and_grads(tp, cfg, batch, **kw)
        if "attn_layout" not in kw:            # recomputation: bit for bit
            assert torch.equal(l, base_l)
            for a, b in zip(tree_leaves(g), tree_leaves(base_g)):
                assert torch.equal(a, b)
        else:            # the same values, summed in another f32 order
            torch.testing.assert_close(l, base_l, rtol=1e-6, atol=1e-7)
            for a, b in zip(tree_leaves(g), tree_leaves(base_g)):
                _assert_leaf_close(a.numpy(), b.numpy())
    if cfg.arch_type in ("dense", "moe"):
        jl = jmdl.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                          attn_layout="flat")
        l, _ = _port_loss_and_grads(tp, cfg, batch, attn_layout="flat")
        np.testing.assert_allclose(float(l), float(jl), **GRAD_TOL)
    if cfg.arch_type != "ssm":          # a model with attention layers
        with pytest.raises(ValueError, match="layout"):
            mdl.loss_fn(tp, cfg, {k: torch.as_tensor(v)
                                  for k, v in batch.items()},
                        attn_layout="wide")


def test_cosine_schedule_matches_jax():
    for base, warm, total, floor in ((3e-4, 10, 100, 0.1), (1e-3, 15, 300,
                                                            0.1),
                                     (0.5, 0, 7, 0.0), (2e-3, 1, 1, 0.3)):
        j = joptim.cosine_schedule(base, warm, total, floor)
        t = toptim.cosine_schedule(base, warm, total, floor)
        steps = np.arange(total + 6, dtype=np.int32)
        want = np.asarray(jax.vmap(j)(jnp.asarray(steps)))
        got = t(torch.as_tensor(steps)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        for s in (0, warm, total + 5):
            assert abs(float(t(s)) - float(j(s))) <= 1e-7


def test_callable_lr_matches_jax_and_batches_per_client():
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    g = {"w": rng.standard_normal((3, 4)).astype(np.float32)}
    sched = dict(base_lr=1e-2, warmup=2, total=6)
    for name in ("AdamW", "SGD"):
        jopt = getattr(joptim, name)(lr=joptim.cosine_schedule(**sched),
                                     clip_norm=1.0)
        topt = getattr(toptim, name)(lr=toptim.cosine_schedule(**sched),
                                     clip_norm=1.0)
        jpar, jst = jax.tree.map(jnp.asarray, p), None
        tpar = {"w": torch.as_tensor(p["w"])}
        jst, tst = jopt.init(jpar), topt.init(tpar)
        for _ in range(4):
            jpar, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jpar)
            tpar, tst = topt.update({"w": torch.as_tensor(g["w"])}, tst,
                                    tpar)
        np.testing.assert_allclose(tpar["w"].numpy(), np.asarray(jpar["w"]),
                                   rtol=1e-6, atol=1e-7)
        # three clients, each at its own step: each row moves by its rate
        pb = {"w": torch.as_tensor(p["w"])}
        st = topt.init(pb, batch=3)
        st = (st._replace(step=torch.tensor([0, 2, 5], dtype=torch.int32))
              if name == "AdamW" else torch.tensor([0, 2, 5],
                                                   dtype=torch.int32))
        new, _ = topt.update({"w": torch.as_tensor(g["w"])}, st, pb)
        for c, s in enumerate((0, 2, 5)):
            one = getattr(toptim, name)(lr=float(topt.lr(s + 1)),
                                        clip_norm=1.0)
            st1 = one.init({"w": pb["w"][c]})
            st1 = (st1._replace(step=torch.tensor(s, dtype=torch.int32))
                   if name == "AdamW" else torch.tensor(s,
                                                        dtype=torch.int32))
            want, _ = one.update({"w": torch.as_tensor(g["w"][c])}, st1,
                                 {"w": pb["w"][c]})
            torch.testing.assert_close(new["w"][c], want["w"], rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_markov_lm_batches_bit_equal(seed):
    j, t = JMarkovLM(300, seed=seed), MarkovLM(300, seed=seed)
    np.testing.assert_array_equal(t.trans_cdf, j.trans_cdf)
    jit, tit = j.batches(4, 33), t.batches(4, 33)
    for _ in range(3):
        a, b = next(jit), next(tit)
        for k in ("tokens", "labels"):
            assert b[k].dtype == a[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], a[k])


def test_five_train_steps_match_jax():
    jcfg = jget_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    jp = jmdl.init_params(jax.random.PRNGKey(3), jcfg)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")
    jstep, jopt = jsteps.make_train_step(jcfg, q_chunk=16)
    tstep, topt = tsteps.make_train_step(cfg, q_chunk=16)
    jstep = jax.jit(jstep)
    jst, tst = jopt.init(jp), topt.init(tp)
    data = MarkovLM(cfg.vocab, seed=5)
    it = data.batches(B, 32)
    jloss, tloss = [], []
    for _ in range(5):
        b = next(it)
        jp, jst, jl = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()})
        tp, tst, tl = tstep(tp, tst, {k: torch.as_tensor(v)
                                      for k, v in b.items()})
        jloss.append(float(jl))
        tloss.append(float(tl))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert int(tst.step) == 5
    lr = 3e-4
    off = total = 0
    for w, g in zip(_leaves(jp), _tleaves(tp)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0.1 * lr)
        off += int((np.abs(g - w) > 1e-7 + 1e-5 * np.abs(w)).sum())
        total += w.size
    assert off <= 1e-3 * total, (off, total)


def test_prefill_and_decode_steps_match_jax():
    jcfg = jget_config("qwen2-1.5b").reduced()
    cfg = get_config("qwen2-1.5b").reduced()
    jp = jmdl.init_params(jax.random.PRNGKey(6), jcfg)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, 12)).astype(
        np.int32)
    jl, jc = jsteps.make_prefill_step(jcfg, q_chunk=12)(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tsteps.make_prefill_step(cfg, q_chunk=12)(
        tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    jc, tc = jextend_cache(jc, 16), extend_cache(tc, 16)
    jdec = jsteps.make_decode_step(jcfg)
    tdec = tsteps.make_decode_step(cfg)
    tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
    for t in range(3):
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(12 + t))
        tl, tc = tdec(tp, tc, torch.as_tensor(tok), 12 + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.argmax(np.asarray(jl)[:, 0], -1)[:, None].astype(np.int32)


def test_train_loop_learns_and_checkpoints(tmp_path):
    from repro_torch.launch.train import train_loop
    from repro_torch.train_lm import CFG_QUICK
    cfg = dataclasses.replace(CFG_QUICK, n_layers=2)
    path = tmp_path / "lm.msgpack"
    params, hist = train_loop(cfg, steps=30, batch=4, seq=32, lr=3e-3,
                              log_every=100, ckpt_path=path, device="cpu")
    assert len(hist) == 30 and all(np.isfinite(hist))
    assert np.mean(hist[-5:]) < hist[0] - 0.1
    blob = ckpt.restore(path, device="cpu")
    assert blob["step"] == 30
    got = blob["params"]
    for a, b in zip(tree_leaves(params), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_drivers_run_on_cpu(capsys, tmp_path):
    from repro_torch import train_lm
    from repro_torch.launch import serve, train
    hist = train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert len(hist) == 3
    assert "final loss" in capsys.readouterr().out
    out = serve.main(["--arch", "qwen2-1.5b", "--reduced", "--batch", "2",
                      "--prompt-len", "8", "--new-tokens", "4",
                      "--device", "cpu"])
    assert out["tokens"].shape == (2, 5)
    assert "tok/s" in capsys.readouterr().out
    hist = train_lm.main(["--quick", "--steps", "2", "--device", "cpu",
                          "--ckpt", str(tmp_path / "q.msgpack")])
    assert len(hist) == 2 and (tmp_path / "q.msgpack").is_file()
    assert "repro-12m" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu"])
