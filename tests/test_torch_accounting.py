"""Step accounting of the port (``launch/{mesh,op_analysis,specs,dryrun,
roofline}.py``) against the reference's dry-run: the abstract parameter
tree and its counts for every arch, the counted FLOPs of the train,
prefill and decode steps against ``HloCosts`` of the reference's compiled
step, the same count on the meta device and on the CPU, the hand kernels
counted once by formula, the layouts against the reference's
PartitionSpecs on 2×2, 16×16 and 2×16×16 meshes, and the data sheet."""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import HloCosts
from repro.models import model as jmdl
from repro_torch import convert
from repro_torch.config import INPUT_SHAPES, InputShape
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import specs as SP
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import H100, device_peaks
from repro_torch.launch.op_analysis import OpCosts, roofline_terms
from repro_torch.models import model as mdl

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 64          # the parity steps' batch and sequence


def _torch_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _torch_leaves(v, f"{path}['{k}']")
    else:
        yield path, tree


def _jax_leaves(tree):
    return [(jax.tree_util.keystr(p), a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)]


def _sig(leaves) -> dict:
    return {p: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for p, a in leaves}


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_tree_and_counts_equal_reference(arch):
    """The meta-device tree (names, shapes, dtypes), n_params and n_active
    equal ``jax.eval_shape(init_params)`` and the reference's rule
    (``repro/launch/dryrun.py:162-171``), exactly."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jp = jax.eval_shape(functools.partial(jmdl.init_params, cfg=jcfg),
                        jax.random.PRNGKey(0))
    tp = dryrun.abstract_params(cfg)
    assert all(t.device.type == "meta" for _, t in _torch_leaves(tp))
    assert _sig(_torch_leaves(tp)) == _sig(_jax_leaves(jp))
    jl = jax.tree.leaves(jp)
    frac = (jcfg.moe.top_k / jcfg.moe.num_experts) if jcfg.moe else 1.0
    assert mdl.param_count(tp) == sum(int(np.prod(x.shape)) for x in jl)
    assert mdl.active_param_count(tp, cfg) == sum(
        int(np.prod(x.shape) * (frac if len(x.shape) == 4 else 1.0))
        for x in jl)


@pytest.mark.parametrize("arch", list_archs())
def test_meta_tree_equals_the_cpu_tree(arch):
    cfg = get_config(arch).reduced()
    assert (_sig(_torch_leaves(mdl.init_params(0, cfg, device="meta")))
            == _sig(_torch_leaves(mdl.init_params(0, cfg, device="cpu"))))


def _ref_flops(arch: str, kind: str) -> float:
    cfg = jget_config(arch).reduced()
    params = jax.eval_shape(functools.partial(jmdl.init_params, cfg=cfg),
                            jax.random.PRNGKey(0))
    i32 = jnp.int32
    sds = jax.ShapeDtypeStruct
    if kind == "train":
        step, opt = jsteps.make_train_step(cfg)
        args = (params, jax.eval_shape(opt.init, params),
                {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)})
    elif kind == "prefill":
        step = jsteps.make_prefill_step(cfg)
        args = (params, {"tokens": sds((B, S), i32)})
    else:
        step = jsteps.make_decode_step(cfg)
        cache = jax.eval_shape(functools.partial(jmdl.init_decode_cache,
                                                 cfg, B, S))
        args = (params, cache, sds((B, 1), i32), sds((), i32))
    hlo = jax.jit(step).lower(*args).compile().as_text()
    return HloCosts(hlo).totals()["flops"]


def _port_costs(arch: str, kind: str, device: str, b=B, s=S) -> OpCosts:
    cfg = get_config(arch).reduced()
    shape = InputShape("t", s, b, kind)
    params = mdl.init_params(0, cfg, device=device)
    inputs, _ = SP.input_shapes(cfg, shape, {"data": 1, "model": 1},
                                device=device)
    if device != "meta":                       # values for a real step
        inputs = {k: (torch.zeros_like(v) if torch.is_tensor(v) else
                      {n: {m: torch.zeros_like(t) for m, t in c.items()}
                       for n, c in v.items()})
                  for k, v in inputs.items()}
        if "pos" in inputs:
            inputs["pos"] = torch.tensor(5, dtype=torch.int32)
    return dryrun.count_step(cfg, shape, params, inputs)[0]


def _moe_recomputed_gate(cfg, n_units):
    """FLOPs of the MoE gate contraction ("etd,te->td", 2·E·T·d) that
    the remat recomputes in each unit that ends with a MoE dispatch: the
    dispatch's forward runs whole before it saves its tensors, where
    XLA's remat recomputes only what the backward reads. Counted by the
    port, not by the reference."""
    return n_units * 2 * cfg.moe.num_experts * B * S * cfg.d_model


def _ssd_transposes(cfg, n_layers):
    """FLOPs of the dots XLA forms when transposing the reference's
    three-operand SSD einsums (y_diag, chunk_state, y_off): per Mamba
    layer two of 2·B·S·H·st, one of 2·B·S·H·hd and one of 2·B·S·Q·H. The
    port multiplies their middle factor in first and its autograd forms
    those as broadcast products (elementwise): counted by the reference,
    not by the port."""
    s = cfg.ssm
    H = cfg.d_model * s.expand // s.head_dim
    Q = min(s.chunk, S)
    return n_layers * 2 * B * S * H * (2 * s.d_state + s.head_dim + Q)


#: (arch, kind) → port FLOPs − reference FLOPs, each differing op named
DIFFERING = {
    ("phi3.5-moe-42b-a6.6b", "train"): lambda c: _moe_recomputed_gate(c, 2),
    ("mamba2-370m", "train"): lambda c: -_ssd_transposes(c, 2),
    ("jamba-1.5-large-398b", "train"):
        lambda c: _moe_recomputed_gate(c, 1) - _ssd_transposes(c, 7),
}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b",
                                  "mamba2-370m", "jamba-1.5-large-398b"])
def test_counted_flops_equal_reference_hlo(arch, kind):
    """Reduced dense, MoE, SSM and hybrid steps counted on the meta device
    equal ``HloCosts(...).totals()["flops"]`` of the reference's step,
    jitted and compiled on the CPU: exactly, or within 1% where the
    difference is exactly the named ops of ``DIFFERING``."""
    want = _ref_flops(arch, kind)
    got = _port_costs(arch, kind, "meta").flops
    diff = DIFFERING.get((arch, kind), lambda c: 0)(get_config(arch).reduced())
    assert got - want == diff
    assert abs(got - want) <= 0.01 * want


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b"])
def test_meta_count_equals_cpu_count(arch, kind):
    """The same step counts the same FLOPs, bytes and kernel calls on the
    meta device and on CPU tensors (T = 32 tokens)."""
    meta = _port_costs(arch, kind, "meta", b=2, s=16)
    cpu = _port_costs(arch, kind, "cpu", b=2, s=16)
    assert meta.totals() == cpu.totals()
    assert meta.kernels == cpu.kernels
    assert meta.flops > 0 and meta.op_bytes > 0


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "jamba-1.5-large-398b"])
def test_moe_meta_count_equals_cpu_count_over_slices(arch, kind):
    """At T = 160 tokens the dense dispatch runs three slices on the CPU
    (64, 64, 32) and none on the meta device, which records their work
    by slice length: the two count the same."""
    meta = _port_costs(arch, kind, "meta", b=2, s=80)
    cpu = _port_costs(arch, kind, "cpu", b=2, s=80)
    assert meta.totals() == cpu.totals()
    assert meta.kernels == cpu.kernels
    assert meta.kernels["moe_dense_dispatch"]["calls"] > 0


def test_dense_dispatch_records_the_ops_of_its_slices():
    """What the dense dispatch records, forward and gradient, equals the
    ops of its slices counted one by one on the CPU."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(3)
    E, d, f, T = 4, 16, 24, 160
    ws = [torch.randn(s, generator=g).requires_grad_()
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    xt = torch.randn(T, d, generator=g).requires_grad_()
    gate = torch.rand(T, E, generator=g).requires_grad_()
    go = torch.randn(T, d, generator=g)
    with OpCosts() as rec:
        out = moe._DenseExperts.apply(xt, gate, *ws, True)
        torch.autograd.grad(out, [xt, gate, *ws], go)
    plain = [w.detach() for w in ws]
    with OpCosts() as fwd:
        buf = torch.empty(T, d)
        acts = [moe._slice_forward(xt.detach()[t0:t0 + t],
                                   gate.detach()[t0:t0 + t], *plain,
                                   buf[t0:t0 + t])
                for t0, t in moe._slices(T)]
    with OpCosts() as bwd:
        dx, dg, dws = moe._grad_buffers(xt, gate, plain)
        for (t0, t), a in zip(moe._slices(T), acts):
            r = slice(t0, t0 + t)
            moe._slice_backward(go[r], xt.detach()[r], gate.detach()[r],
                                plain, *a, dx[r], dg[r], dws)
    assert len(moe._slices(T)) == 3
    k = rec.kernels
    assert (k["moe_dense_dispatch"]["flops"],
            k["moe_dense_dispatch"]["bytes"]) == (fwd.flops, fwd.op_bytes)
    assert (k["moe_dense_dispatch_grad"]["flops"],
            k["moe_dense_dispatch_grad"]["bytes"]) == (bwd.flops,
                                                       bwd.op_bytes)


def test_each_kernel_counts_its_formula_once():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    h, aw, ab, cw, cb = r(16, 32), r(32, 5), r(5), r(32, 5), r(5)
    q, k, v = r(2, 2, 4, 64), r(2, 2, 48, 64), r(2, 2, 48, 64)
    nv = torch.tensor([48, 7], dtype=torch.int32)
    x, c, w = r(3, 40, 8), r(6, 5, 8), torch.ones(3, 40)
    pool = r(9, 2, 16, 64)
    table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    fq = r(1, 32, 2, 64)
    cases = [
        ("router_utility", lambda: ops.router_utility(h, aw, ab, cw, cb, 0.5,
                                                      impl="ref"),
         4 * 16 * 32 * 5),
        ("decode_attention", lambda: ops.decode_attention(q, k, v, nv,
                                                          impl="ref"),
         4 * 2 * 2 * 4 * 48 * 64),
        ("paged_decode_attention", lambda: ops.paged_decode_attention(
            q, pool, pool, table, nv, impl="ref"), 4 * 2 * 2 * 4 * 48 * 64),
        ("kmeans_assign", lambda: ops.kmeans_assign(x, c, impl="ref"),
         2 * 6 * 40 * 5 * 8),
        ("kmeans_assign_reduce", lambda: ops.kmeans_assign_reduce(
            x, c, w, impl="ref"), 2 * 6 * 40 * 5 * 8 + 2 * 6 * 40 * 8),
        ("flash_attention", lambda: ops.flash_attention(fq, fq, fq,
                                                        impl="ref"),
         4 * 1 * 2 * 32 * 32 * 64),
    ]
    for name, call, flops in cases:
        with OpCosts() as oc:
            call()
        assert oc.kernels == {name: {"calls": 1, "flops": flops,
                                     "bytes": oc.op_bytes}}, name
        assert oc.flops == flops and dict(oc.by_op) == {name: flops}, name
        assert oc.op_bytes > 0
    with OpCosts() as oc:                 # nothing counted outside a mode
        pass
    ops.decode_attention(q, k, v, nv, impl="ref")
    assert oc.totals()["flops"] == 0 and not oc.kernels


def test_collectives_are_counted_by_kind(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        t = torch.ones(6, 5)
        with OpCosts() as oc:
            out = torch.empty(6, 5)
            getattr(dist, "all_gather_single",
                    dist.all_gather_into_tensor)(out, t)
            dist.all_reduce(t)
        assert oc.collectives == {"all-gather": 120, "all-reduce": 120}
        assert oc.totals()["collective_bytes"] == 240
    finally:
        dist.destroy_process_group()


def test_data_sheet_and_roofline_terms():
    p = device_peaks(H100)
    assert p["name"] == H100 and p["hbm_bytes_per_s"] == 3.35e12
    assert p["flops"]["bfloat16"] == 989e12 and p["flops"]["float32"] == 67e12
    with pytest.raises(KeyError, match="no data sheet"):
        device_peaks("NVIDIA GeForce RTX 4090")
    with pytest.raises(KeyError, match="no data sheet"):
        device_peaks("TPU v5e")
    t = roofline_terms({"flops": 989e12, "op_bytes": 6.7e12}, p, "bfloat16")
    assert t["compute_s"] == 1.0 and t["memory_s"] == 2.0
    assert t["collective_s"] == 0.0 and t["dominant"] == "memory"
    assert t["device"] == H100
    t = roofline_terms({"flops": 1.0, "op_bytes": 1.0}, p, "float32",
                       n_devices=4)
    assert t["collective_s"] is None


def test_dryrun_records_skips_and_caches(tmp_path, capsys):
    path = tmp_path / "dry.jsonl"
    recs = dryrun.run_all([("qwen2-1.5b", "decode_32k"),
                           ("qwen2-1.5b", "long_500k"),
                           ("hubert-xlarge", "long_500k")], path=path)
    dec, lng, hub = recs
    assert dec["status"] == "ok" and not dec["rolling"]
    assert lng["rolling"] and hub == {**hub, "status": "skipped",
                                      "reason": "encoder-only: no decode step"}
    cfg = get_config("qwen2-1.5b")
    assert dec["n_params"] == 1_777_088_000
    assert dec["model_flops"] == 2 * dec["n_active"] * 128
    # decode: every layer's q·k and p·v over the whole 32k cache, by formula
    att = dec["kernels"]["decode_attention"]
    assert att["calls"] == cfg.n_layers
    assert att["flops"] == cfg.n_layers * 4 * 128 * cfg.n_heads * 32768 * 128
    assert dec["counted_flops"] > dec["model_flops"]
    assert dec["min_bytes"] <= dec["op_bytes"]
    assert dec["state_bytes_global"] == dec["state_bytes_per_device"]
    assert dec["memory_s"] == dec["op_bytes"] / 3.35e12
    assert dec["dominant"] == "memory" and dec["collective_s"] == 0.0
    again = dryrun.run_all([("qwen2-1.5b", "decode_32k")], path=path,
                           verbose=False)
    assert again[0] == dec and len(path.read_text().splitlines()) == 3
    lines = roofline.main(["--path", str(path)])
    assert lines[-1] == json.dumps({"roofline": {"ok": 2, "skipped": 1,
                                                 "error": 0}})
    # a mesh splits the state by the layouts; nothing ran there
    rec = dryrun.run_combo("qwen2-1.5b", "long_500k",
                           mesh_shape={"data": 2, "model": 4})
    assert rec["mesh"] == "2x4" and rec["collective_s"] is None
    assert rec["state_bytes_per_device"] < rec["state_bytes_global"] / 4


def test_min_bytes_of_a_train_step():
    cfg = get_config("qwen2-1.5b")
    shape = InputShape("lm", 256, 8, "train")
    params = dryrun.abstract_params(cfg)
    inputs, _ = SP.input_shapes(cfg, shape, {"data": 1, "model": 1})
    costs, opt = dryrun.count_step(cfg, shape, params, inputs)
    p = 1_777_088_000
    assert dryrun.min_bytes(cfg, shape, params, inputs, opt) == (
        4 * 2 * p + 4 * 4 * p + 2 * 8 * 256 * 4)
    # 6·N·T less the token gather's share, plus each unit's forward again
    # but its last product (remat stops once its saved tensors are back),
    # plus attention
    assert 6 * p * 2048 * 0.8 < costs.flops < 8 * p * 2048


_LAYOUTS = r"""
import functools, json
import jax
from jax.sharding import Mesh
from repro.config import INPUT_SHAPES
from repro.configs import get_config, list_archs
from repro.launch import specs as SP
from repro.launch.mesh import make_production_mesh
from repro.models import model as mdl

def spec(s):
    return [list(a) if isinstance(a, tuple) else a for a in s.spec]

def flat(tree):
    return {jax.tree_util.keystr(p): spec(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))}

meshes = {"2x2": jax.make_mesh((2, 2), ("data", "model"),
                               devices=jax.devices()[:4]),
          "16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True)}
out = {}
for mname, mesh in meshes.items():
    for arch in list_archs():
        cfg = get_config(arch)
        ps = jax.eval_shape(functools.partial(mdl.init_params, cfg=cfg),
                            jax.random.PRNGKey(0))
        rec = {"params": flat(SP.param_specs(mesh, cfg, ps))}
        for sname, shape in INPUT_SHAPES.items():
            rec["rules/" + sname] = {k: list(v) if isinstance(v, tuple)
                                     else v for k, v in
                                     SP.activation_rules(mesh, shape).items()}
            if shape.kind == "decode" and not cfg.supports_decode:
                continue
            _, sp = SP.input_specs(cfg, shape, mesh)
            rec["inputs/" + sname] = flat(sp)
        out[mname + "/" + arch] = rec
print(json.dumps(out))
"""


def _flat_layouts(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_layouts(v, f"{path}['{k}']"))
        return out
    return {path: [list(a) if isinstance(a, tuple) else a for a in tree]}


def test_layouts_equal_reference_partition_specs():
    """Every arch's parameter layouts, input and cache layouts and
    activation rules equal the reference's PartitionSpecs on a 2×2, a
    16×16 and a 2×16×16 mesh (one subprocess forces the reference's 512
    CPU devices, as ``tests/test_mesh.py`` does)."""
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    res = subprocess.run([sys.executable, "-c", _LAYOUTS], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout.splitlines()[-1])
    meshes = {"2x2": {"data": 2, "model": 2},
              "16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}
    trees = {a: dryrun.abstract_params(get_config(a)) for a in list_archs()}
    assert len(want) == 3 * len(trees)
    for key, rec in want.items():
        mname, arch = key.split("/")
        ms, cfg = meshes[mname], get_config(arch)
        assert _flat_layouts(SP.param_layouts(ms, cfg, trees[arch])) \
            == rec["params"], key
        for sname, shape in INPUT_SHAPES.items():
            rules = json.loads(json.dumps(SP.activation_rules(ms, shape)))
            assert rules == rec["rules/" + sname], (key, sname)
            if "inputs/" + sname not in rec:
                continue
            _, lay = SP.input_shapes(cfg, shape, ms)
            assert _flat_layouts(lay) == rec["inputs/" + sname], (key, sname)


def test_per_device_bytes():
    t = {"a": torch.empty((16, 8), dtype=torch.bfloat16, device="meta"),
         "b": {"c": torch.empty((6, 4), device="meta")}}
    lay = {"a": ("data", "model"), "b": {"c": (None, ("pod", "data"))}}
    ms = {"pod": 2, "data": 2, "model": 4}
    assert SP.per_device_bytes(t, lay, ms) == 16 * 8 * 2 // 8 + 6 * 4 * 4 // 4
    assert SP._fit(ms, ("model", "data"), (6, 4)) == (None, "data")


def test_vlm_train_step_equals_reference():
    """A VLM trains from embeddings, so its token table takes no gradient:
    the port's train step gives it a zero gradient (as ``jax.grad`` does)
    and one step equals the reference's."""
    jcfg = jget_config("internvl2-2b").reduced()
    cfg = get_config("internvl2-2b").reduced()
    jp = jmdl.init_params(jax.random.PRNGKey(1), jcfg)
    tp = convert.model_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")
    rng = np.random.default_rng(0)
    b = {"embeds": rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32),
         "labels": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    jstep, jopt = jsteps.make_train_step(jcfg, q_chunk=16)
    tstep, topt = tsteps.make_train_step(cfg, q_chunk=16)
    jp2, _, jl = jax.jit(jstep)(jp, jopt.init(jp),
                                {k: jnp.asarray(v) for k, v in b.items()})
    tp2, _, tl = tstep(tp, topt.init(tp),
                       {k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = {p: np.asarray(a) for p, a in _jax_leaves(jp2)}
    # AdamW's first step moves an element by about lr·sign(g): an element
    # whose gradient is at float noise may move the other way (as in
    # test_torch_lm_train.py's five steps)
    lr, off, total = 3e-4, 0, 0
    for p, t in _torch_leaves(tp2):
        g, w = t.numpy(), want[p]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2 * lr, err_msg=p)
        off += int((np.abs(g - w) > 1e-7 + 1e-5 * np.abs(w)).sum())
        total += w.size
    assert off <= 1e-3 * total, (off, total)
    # the token table took no gradient: weight decay alone moved it
    tok0 = tp["embed"]["tok"].numpy()
    np.testing.assert_allclose(tp2["embed"]["tok"].numpy(),
                               tok0 * (1 - lr * 0.1), rtol=1e-6)
