"""The PyTorch port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX, jaxlib or the JAX package (``repro``), none
imports msgpack at module level (the GPU machine has none), and the entry
points run on the CPU only when asked to."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imports(tree):
    """(module name, at module level) for every import in the tree."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top_level in _imports(tree):
        root = name.split(".")[0]
        assert root not in BANNED, f"{path.name} imports {name}"
        assert not (root == "msgpack" and top_level), (
            f"{path.name} imports msgpack at module level")


def test_port_has_every_slice_module():
    want = ["config.py", "configs/__init__.py", "data/encoder.py",
            "kernels/ref.py", "kernels/router_utility.py",
            "kernels/decode_attention.py", "kernels/ops.py",
            "kernels/csrc/router_utility.cu",
            "kernels/csrc/decode_attention.cu", "models/layers.py",
            "models/attention.py", "models/model.py", "serve/kv_cache.py",
            "serve/engine.py", "serve/gateway.py", "core/mlp_router.py",
            "routers/base.py", "routers/registry.py", "routers/mlp.py",
            "convert.py",
            # slice 2: the federated router fit
            "train/checkpoint.py", "train/optim.py",
            "kernels/kmeans_assign.py", "kernels/csrc/kmeans_assign.cu",
            "data/synthetic.py", "data/partition.py", "core/policy.py",
            "fed/aggregators.py", "core/federated.py", "core/kmeans.py",
            "core/kmeans_router.py", "routers/fit.py", "routers/kmeans.py",
            "quickstart.py",
            # slice 3: the last kernel and the paper's remaining features
            "kernels/flash_attention.py", "kernels/csrc/flash_attention.cu",
            "core/mf_router.py", "routers/mf.py", "core/expansion.py",
            "core/elo_router.py", "routers/elo.py",
            "core/personalization.py", "core/secure_agg.py",
            # slice 7: the whole serving engine and qk-norm (qwen3-8b)
            "configs/qwen3_8b.py",
            # slice 8: MoE, SSM, hybrid, VLM and audio architectures
            "models/moe.py", "models/ssm.py"]
    pkg = ROOT / "src" / "repro_torch"
    assert [w for w in want if not (pkg / w).is_file()] == []
    # slices 7 and 8 grew modules that slice 1 began: what each must now
    # define
    defs = {"serve/kv_cache.py": ["alloc_draft_pool", "grow", "held"],
            "models/attention.py": ["_masked_grouped_attn_multi",
                                    "attn_decode_verify",
                                    "attn_decode_verify_paged",
                                    "verify_attention",
                                    "verify_attention_paged"],
            "models/model.py": ["decode_verify", "decode_verify_paged",
                                "block_pattern", "active_param_count"],
            "models/layers.py": ["init_layernorm", "layernorm"],
            "serve/engine.py": ["Outcome", "cancel", "status", "counters",
                                "_expire", "_preempt", "_grow_for_chunk",
                                "_admit_draft", "_decode_spec_round"],
            "serve/gateway.py": ["_pick_draft", "cancel", "status"]}
    missing = []
    for f, names in defs.items():
        tree = ast.parse((pkg / f).read_text())
        have = {n.name for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
        missing += [f"{f}::{n}" for n in names if n not in have]
    assert missing == []


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    from repro_torch import routers
    from repro_torch.config import FedConfig, ModelConfig, RouterConfig
    from repro_torch.models import init_params
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.gateway import RoutedServer, make_pool_model

    TINY = ModelConfig(name="tiny", arch_type="dense", n_layers=1, d_model=32,
                       n_heads=2, n_kv_heads=1, d_ff=64, vocab=97,
                       head_dim=16)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(0, TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pool_model("tiny", TINY, 0.1)
    rcfg = RouterConfig(d_emb=16, num_models=1, hidden=(8,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        routers.make("mlp", rcfg).init(0)
    pool = [make_pool_model("tiny", TINY, 0.1, device="cpu")]
    router = routers.make("mlp", rcfg).init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RoutedServer(pool, router)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(pool)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(pool, device="cuda")
    # with device="cpu" everything runs
    srv = RoutedServer(pool, router, device="cpu")
    out = srv.generate(["hello there"], max_new_tokens=2)
    assert len(out["results"][0]["tokens"]) == 2

    # the fit entry points
    fcfg = FedConfig(num_clients=2, rounds=1)
    data = {"x": torch.randn((2, 20, 16)), "m": torch.zeros((2, 20),
                                                            dtype=torch.int32),
            "acc": torch.ones((2, 20)), "cost": torch.zeros((2, 20)),
            "w": torch.ones((2, 20))}
    flat = {k: v[0] for k, v in data.items()}
    kcfg = RouterConfig(d_emb=16, num_models=1, k_local=3, k_global=2,
                        kmeans_iters=2, n_init=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        routers.make("kmeans", kcfg).init(0)
    for fam in ("mf", "elo"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            routers.make(fam, kcfg).init(0)
    for fam, cfg in (("mlp", rcfg), ("kmeans", kcfg), ("mf", kcfg),
                     ("elo", kcfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            routers.fit_federated(routers.make(fam, cfg), data, fcfg, gen=0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            routers.fit_local(routers.make(fam, cfg), flat, fcfg, gen=0)
        fitted, _ = routers.fit_federated(routers.make(fam, cfg), data, fcfg,
                                          gen=0, device="cpu")
        assert fitted.device == torch.device("cpu")
        fitted, _ = routers.fit_local(routers.make(fam, cfg), flat, fcfg,
                                      gen=0, device="cpu", steps=2)
        assert fitted.route(flat["x"], 0.5).shape == (20,)
