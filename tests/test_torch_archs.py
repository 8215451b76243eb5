"""The PyTorch port's non-dense architectures against the JAX reference on
the CPU: MoE (phi-3.5-MoE, kimi-k2), SSM (mamba2-370m), hybrid (jamba:
one attention and seven Mamba layers a unit, MoE every other layer), VLM
(internvl2-2b, token or embedding input) and the encoder-only audio model
(hubert: LayerNorm, GELU MLP, no token table, bidirectional attention).

Each arch runs at ``ModelConfig.reduced()`` in f32 with the reference's
weights carried over by ``repro_torch.convert``. Held: the parameter tree,
the counts of ``param_count`` and ``active_param_count``, prefill logits
and aux loss, the decode cache, three decode steps; ``convert`` on every
tree and its refusals; the MoE engine's tokens equal to the JAX engine's
and to the port's per-call tokens; the SSM and hybrid per-call tokens
equal to the JAX gateway's (prompts of 3 words or more, where the
reference's prefill cache is sound) and, at 1 to 5 words, to the port's
own token-by-token decode; and the engine's refusal of SSM/hybrid models.
f32 to 1e-4 (as ``test_torch_models.py``: errors grow through the layers),
greedy tokens equal.
"""
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import routers as jrouters
from repro.config import RouterConfig as JRouterConfig
from repro.configs import get_config as jget_config
from repro.models import model as jmdl
from repro.serve import engine as jengine
from repro.serve import gateway as jgateway
from repro.serve.kv_cache import extend_cache as jextend_cache
from repro_torch import convert, routers
from repro_torch.config import RouterConfig
from repro_torch.configs import get_config
from repro_torch.models import model as mdl
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.gateway import PoolModel, RoutedServer
from repro_torch.serve.kv_cache import extend_cache

torch.set_num_threads(1)

MOE = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]
STATEFUL = ["mamba2-370m", "jamba-1.5-large-398b"]
DECODERS = MOE + STATEFUL + ["internvl2-2b"]
ALL = DECODERS + ["hubert-xlarge"]
J_FORWARD = jax.jit(jmdl.forward, static_argnums=1,
                    static_argnames=("return_cache", "q_chunk",
                                     "logits_last_only"))
J_DECODE = jax.jit(jmdl.decode_step, static_argnums=2)
TOL = dict(rtol=1e-4, atol=1e-4)

_PAIRS = {}


def pair(arch):
    """(JAX cfg, port cfg, JAX params, port params), reduced f32."""
    if arch not in _PAIRS:
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        assert asdict(cfg) == asdict(jcfg)
        jp = jmdl.init_params(jax.random.PRNGKey(ALL.index(arch)), jcfg)
        tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp),
                                             cfg, device="cpu")
        _PAIRS[arch] = (jcfg, cfg, jp, tp)
    return _PAIRS[arch]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, size=(B, S)).astype(np.int32)


def _allclose_tree(got: dict, want: dict):
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ALL)
def test_param_tree_and_counts_match_the_reference(arch):
    jcfg, cfg, jp, tp = pair(arch)
    own = mdl.init_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(own)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    assert mdl.param_count(own) == jmdl.param_count(jp)
    assert (mdl.active_param_count(own, cfg)
            == jmdl.active_param_count(jp, jcfg))
    assert mdl.block_pattern(cfg) == jmdl.block_pattern(jcfg)


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_cache_and_decode_match_jax(arch):
    """Prefill (logits, aux loss, cache), then three decode steps against
    the extended cache: logits and every cache leaf."""
    jcfg, cfg, jp, tp = pair(arch)
    B, S, steps = 2, 7, 3
    toks = _tokens(cfg, B, S)
    jl, jaux, jc = J_FORWARD(jp, jcfg, tokens=jnp.asarray(toks),
                             return_cache=True, q_chunk=4)
    tl, taux, tc = mdl.forward(tp, cfg, tokens=torch.from_numpy(toks),
                               return_cache=True, q_chunk=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-7)
    _allclose_tree(tc, jc)
    jc, tc = jextend_cache(jc, S + steps), extend_cache(tc, S + steps)
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1)[:, None].astype(np.int32)
    for t in range(steps):
        jlt, jc = J_DECODE(jp, jc, jcfg, tokens=jnp.asarray(tok), pos=S + t)
        tlt, tc = mdl.decode_step(tp, tc, cfg, tokens=torch.from_numpy(tok),
                                  pos=S + t)
        np.testing.assert_allclose(tlt.numpy(), np.asarray(jlt), **TOL)
        assert (tlt.argmax(-1).numpy() == np.asarray(jlt).argmax(-1)).all()
        tok = np.asarray(jlt).argmax(-1).astype(np.int32)
    _allclose_tree(tc, jc)


@pytest.mark.parametrize("arch", ["internvl2-2b", "hubert-xlarge"])
def test_embedding_input_matches_jax(arch):
    """The VLM and the audio encoder take precomputed embeddings (their
    frontends are stubbed); hubert attends both ways, normalizes with
    LayerNorm and has no token table."""
    jcfg, cfg, jp, tp = pair(arch)
    emb = np.random.default_rng(1).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    jl, jaux = J_FORWARD(jp, jcfg, embeds=jnp.asarray(emb), q_chunk=4)
    tl, taux = mdl.forward(tp, cfg, embeds=torch.from_numpy(emb), q_chunk=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(taux) == float(jaux) == 0.0
    if arch == "hubert-xlarge":
        assert "tok" not in tp["embed"] and "bias" in tp["final_norm"]
        assert sorted(tp["blocks"]["l0"]["ffn"]) == ["bi", "bo", "wi", "wo"]


@pytest.mark.parametrize("arch", ALL)
def test_convert_checks_each_tree(arch):
    """Every reduced tree converts; a tree for another depth, width,
    expert count, dtype or arch is refused by name."""
    jcfg, cfg, jp, _ = pair(arch)
    tree = jax.tree.map(np.asarray, jp)
    assert convert.model_params_from_numpy(tree, cfg, device="cpu")
    n_units, pat = mdl.block_pattern(cfg)
    per_unit = len(pat)
    bad = {"depth": (replace(cfg, n_layers=cfg.n_layers + per_unit),
                     "stacked"),
           "width": (replace(cfg, d_model=cfg.d_model * 2), "needs"),
           "dtype": (replace(cfg, dtype="bfloat16"), "runs in")}
    if cfg.moe is not None:
        bad["experts"] = (replace(cfg, moe=replace(
            cfg.moe, num_experts=cfg.moe.num_experts + 1)), "needs")
    if cfg.arch_type == "ssm":
        bad["arch"] = (replace(cfg, arch_type="dense", d_ff=64), "missing")
    for what, (c, match) in bad.items():
        with pytest.raises(ValueError, match=match):
            convert.model_params_from_numpy(tree, c, device="cpu")


def _engine_pair(arch, ecfg_kw):
    jcfg, cfg, jp, tp = pair(arch)
    jeng = jengine.ServeEngine([jgateway.PoolModel(arch, jcfg, jp, 0.1)],
                               jengine.EngineConfig(**ecfg_kw))
    teng = ServeEngine([PoolModel(arch, cfg, tp, 0.1)],
                       EngineConfig(**ecfg_kw), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("arch", MOE)
def test_moe_engine_matches_jax_engine_and_per_call(arch):
    """MoE lanes of the paged engine: the same tokens as the JAX engine
    and as the port's per-call path (dense dispatch: a token's output does
    not depend on its batch mates)."""
    kw = dict(slots=3, max_seq=48, chunk=4, page_size=8)
    jeng, teng = _engine_pair(arch, kw)
    cfg = teng.pool[0].cfg
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(1, cfg.vocab, size=n).astype(np.int32), m)
            for n, m in ((5, 8), (11, 6), (2, 9), (7, 8))]
    outs = []
    for eng in (jeng, teng):
        rids = [eng.submit(0, t, m) for t, m in reqs]
        done = eng.drain()
        outs.append([np.asarray(done[r]) for r in rids])
    for (t, m), a, b in zip(reqs, *outs):
        np.testing.assert_array_equal(b, a)
        solo = RoutedServer._serve_batch(teng.pool[0], t[None], m)[0]
        np.testing.assert_array_equal(b, solo)


def _kmeans_servers(arches):
    """A JAX and a port RoutedServer over ``arches`` with one K-means
    router state: λ 0 routes everything to model 0, λ 2 to model 1."""
    state = {"centroids": np.zeros((1, 16), np.float32),
             "A": np.array([[0.9, 0.5]], np.float32),
             "C": np.array([[1.0, 0.2]], np.float32),
             "n": np.ones((1, 2), np.float32)}
    jr = jrouters.make("kmeans", JRouterConfig(d_emb=16, num_models=2),
                       state=jax.tree.map(jnp.asarray, state))
    tr = routers.make("kmeans", RouterConfig(d_emb=16, num_models=2),
                      state=convert.router_state_from_numpy(state,
                                                            device="cpu"))
    jpool, tpool = [], []
    for arch in arches:
        jcfg, cfg, jp, tp = pair(arch)
        jpool.append(jgateway.PoolModel(arch, jcfg, jp, 0.1))
        tpool.append(PoolModel(arch, cfg, tp, 0.1))
    return (jgateway.RoutedServer(jpool, jr),
            RoutedServer(tpool, tr, device="cpu"))


PROMPTS = ["write a short poem", "prove that two is even",
           "the cat sat", "summarize the plot of the odyssey please"]


def test_ssm_and_hybrid_gateway_match_jax():
    """``generate`` sends SSM and hybrid models to the per-call path, its
    prompts unpadded in S, engine or not: the tokens equal the JAX
    gateway's."""
    jsrv, tsrv = _kmeans_servers(STATEFUL)
    seen = set()
    for lam in (0.0, 2.0):
        for engine in (True, False):
            want = jsrv.generate(PROMPTS, lam=lam, max_new_tokens=5,
                                 engine=engine)
            got = tsrv.generate(PROMPTS, lam=lam, max_new_tokens=5,
                                engine=engine)
            assert got == want
            seen.update(got["routing"])
    assert seen == {0, 1}
    assert tsrv.engine.n_active() == 0 and not tsrv.engine._lanes


@pytest.mark.parametrize("arch", STATEFUL)
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
def test_per_call_equals_token_by_token_decode(arch, S):
    """The per-call path at 1 to 5 prompt tokens gives the tokens of
    decoding the prompt one token at a time from an empty cache and
    continuing greedily (at 1 and 2 tokens the reference's own prefill
    cache breaks, so the port holds itself to its token-by-token
    decode)."""
    _, cfg, _, tp = pair(arch)
    toks = _tokens(cfg, 2, S, seed=S)
    max_new = 6
    got = RoutedServer._serve_batch(PoolModel(arch, cfg, tp, 0.1), toks,
                                    max_new)
    cache = mdl.init_decode_cache(cfg, 2, S + max_new, device="cpu")
    tok = torch.from_numpy(toks[:, :1])
    want = []
    for t in range(S + max_new - 1):
        logits, cache = mdl.decode_step(tp, cache, cfg, tokens=tok, pos=t)
        nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        if t >= S - 1:
            want.append(nxt[:, 0])
        tok = torch.from_numpy(toks[:, t + 1:t + 2]) if t + 1 < S else nxt
    np.testing.assert_array_equal(got, torch.stack(want, 1).numpy())


def test_engine_refuses_ssm_and_hybrid_with_the_references_error():
    jsrv, tsrv = _kmeans_servers(STATEFUL)
    for m, arch in enumerate(STATEFUL):
        cfg = tsrv.pool[m].cfg
        with pytest.raises(TypeError, match="SSM/hybrid"):
            tsrv.engine.submit(m, np.arange(1, 6, dtype=np.int32), 4)
        with pytest.raises(TypeError, match="SSM/hybrid"):
            jsrv.engine.submit(m, np.arange(1, 6, dtype=np.int32), 4)
        with pytest.raises(TypeError, match="paged"):
            mdl.init_paged_cache(cfg, 4, 8, device="cpu")
        with pytest.raises(TypeError, match="verify"):
            mdl.decode_verify(tsrv.pool[m].params, {}, cfg,
                              tokens=np.ones((1, 2), np.int32),
                              pos=np.zeros(1, np.int32))
    with pytest.raises(TypeError, match="SSM/hybrid"):
        tsrv.submit("the cat sat", lam=0.0)


def test_generate_serves_every_decoding_arch():
    """No MoE, SSM, hybrid or VLM model is refused: a five-model pool
    behind one router, every request answered with in-vocabulary tokens,
    the attention archs through the engine."""
    tpool = [PoolModel(a, pair(a)[1], pair(a)[3], 0.1 * (i + 1))
             for i, a in enumerate(DECODERS)]
    rng = np.random.default_rng(3)
    state = {"centroids": torch.zeros((1, 16)),
             "A": torch.from_numpy(rng.uniform(size=(1, 5)).astype(
                 np.float32)),
             "C": torch.from_numpy(rng.uniform(size=(1, 5)).astype(
                 np.float32)),
             "n": torch.ones((1, 5))}
    for m in range(5):
        st = dict(state, A=torch.nn.functional.one_hot(
            torch.tensor([m]), 5).float())
        srv = RoutedServer(tpool, routers.make(
            "kmeans", RouterConfig(d_emb=16, num_models=5), state=st),
            device="cpu")
        out = srv.generate(PROMPTS[:2], lam=0.0, max_new_tokens=3)
        assert out["routing"] == [m, m]
        for r in out["results"]:
            assert r["model"] == DECODERS[m] and len(r["tokens"]) == 3
            assert all(0 <= x < tpool[m].cfg.vocab for x in r["tokens"])
        uses_engine = m not in (DECODERS.index(a) for a in STATEFUL)
        assert bool(srv.engine._lanes) == uses_engine
