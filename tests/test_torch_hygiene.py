"""The PyTorch port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX, jaxlib, the JAX package (``repro``) or
msgpack at any level (the GPU machine has none; checkpoints use the port's
own codec), and the entry points run on the CPU only when asked to."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro", "msgpack")


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
    for name, _ in _imports(tree):
        assert name.split(".")[0] not in BANNED, f"{path.name} imports {name}"


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
            "models/moe.py", "models/ssm.py",
            # slice 9: the federation side of the online loop
            "fed/faults.py", "fed/harvest.py", "fed/__init__.py",
            # slice 10: the FedLoop scheduler, the scenarios, the drivers
            "fed/loop.py", "fed/scenarios.py", "launch/__init__.py",
            "launch/fed_serve.py", "launch/fed_train.py",
            "routed_serving.py",
            # slice 11: the RouterBench harness, LM training and its drivers
            "evalbench/__init__.py", "evalbench/pools.py",
            "evalbench/metrics.py", "evalbench/perturb.py",
            "evalbench/harness.py", "train/lm_data.py", "launch/steps.py",
            "launch/train.py", "launch/serve.py", "train_lm.py",
            # slice 12: the step accounting and the clients mesh
            "launch/mesh.py", "launch/op_analysis.py", "launch/specs.py",
            "launch/dryrun.py", "launch/roofline.py", "sharding.py",
            "kernels/costs.py"]
    pkg = ROOT / "src" / "repro_torch"
    assert [w for w in want if not (pkg / w).is_file()] == []
    # slices 7 to 9 grew modules that slices 1 and 2 began: what each must
    # now define
    defs = {"serve/kv_cache.py": ["alloc_draft_pool", "grow", "held"],
            "models/attention.py": ["_masked_grouped_attn_multi",
                                    "attn_decode_verify",
                                    "attn_decode_verify_paged",
                                    "verify_attention",
                                    "verify_attention_paged"],
            "models/model.py": ["decode_verify", "decode_verify_paged",
                                "block_pattern", "active_param_count",
                                "loss_fn"],
            "models/layers.py": ["init_layernorm", "layernorm"],
            "serve/engine.py": ["Outcome", "cancel", "status", "counters",
                                "_expire", "_preempt", "_grow_for_chunk",
                                "_admit_draft", "_decode_spec_round"],
            "serve/gateway.py": ["_pick_draft", "cancel", "status",
                                 "swap_router_state", "add_model",
                                 "routed_model", "report_outcome",
                                 "_unknown_rid", "_submit_with_failover"],
            "fed/aggregators.py": ["TrimmedMeanAggregator",
                                   "MedianAggregator", "NormClipAggregator",
                                   "BufferedAsyncAggregator"],
            "fed/loop.py": ["FedLoop", "FedLoopConfig", "personalize_client",
                            "step", "drain", "maybe_sync", "sync",
                            "_staleness_vector", "_note_sync", "save",
                            "restore", "onboard_model"],
            "fed/scenarios.py": ["ScenarioConfig", "TrafficScenario",
                                 "PowerLawScenario", "engine_chaos_schedule",
                                 "run_online_vs_frozen", "_frontier_auc"],
            "train/checkpoint.py": ["packb", "unpackb"],
            "train/optim.py": ["cosine_schedule"],
            "evalbench/perturb.py": ["paraphrase_drift", "nearest_donor",
                                     "adversarial_queries"],
            "evalbench/harness.py": ["eval_scenarios", "_aiq_only",
                                     "offline_routerbench",
                                     "online_routerbench"],
            "launch/steps.py": ["make_train_step", "make_prefill_step",
                                "make_decode_step"],
            "launch/train.py": ["train_loop", "main"],
            "core/federated.py": ["fedavg_round_sharded", "pad_client_axis"],
            "core/kmeans_router.py": ["fed_kmeans_router_sharded"],
            "launch/op_analysis.py": ["roofline_terms"],
            "kernels/costs.py": ["OpCosts", "kernel", "measure",
                                 "tensor_bytes"],
            "models/moe.py": ["_DenseExperts", "_slice_forward",
                              "_slice_backward"],
            "launch/specs.py": ["param_layouts", "cache_layouts",
                                "activation_rules", "batch_axes",
                                "input_shapes", "per_device_bytes"],
            "launch/dryrun.py": ["run_combo", "load_done", "min_bytes"],
            "sharding.py": ["make_mesh", "client_mesh", "shard_clients",
                            "ClientRows", "all_gather_rows"]}
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
    from repro_torch.fed import HarvestStore
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
        HarvestStore(16, clients=range(2))
    assert HarvestStore(16, device="cpu").device == torch.device("cpu")
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

    # slice 10: the online loop's entry points and drivers
    from repro_torch import routed_serving
    from repro_torch.fed import ScenarioConfig, TrafficScenario
    from repro_torch.fed import run_online_vs_frozen
    from repro_torch.launch import fed_serve, fed_train
    cfg = ScenarioConfig(n_clients=2, n_tasks=2, n_models=2, d_emb=8,
                         n_queries=60, queries_per_phase=6, phases=1,
                         test_queries=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_online_vs_frozen(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrafficScenario(cfg).make_pool()
    assert TrafficScenario(cfg).make_pool(device="cpu")[0].params[
        "embed"]["unembed"].device == torch.device("cpu")
    for main in (fed_serve.main, fed_train.main, routed_serving.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main([])
    m = run_online_vs_frozen(cfg, device="cpu", local_steps=2)
    assert m["requests_served"] == m["harvested_samples"]

    # slice 11: the RouterBench harness, LM training and the three drivers
    from repro_torch import train_lm
    from repro_torch.evalbench import (make_pool_corpus, offline_routerbench,
                                       online_routerbench)
    from repro_torch.launch import serve, train
    from repro_torch.launch.train import train_loop
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_pool_corpus(0, n_models=2, n_queries=8, d_emb=4)
    corpus = make_pool_corpus(0, n_models=2, n_queries=60, n_tasks=2,
                              d_emb=8, device="cpu")
    assert corpus["x"].device == torch.device("cpu")
    bcfg = RouterConfig(d_emb=8, num_models=2, k_local=2, k_global=2)
    bfcfg = FedConfig(num_clients=2, rounds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        offline_routerbench(0, rcfg=bcfg, fcfg=bfcfg, families=("kmeans",),
                            corpus=corpus)
    res = offline_routerbench(0, rcfg=bcfg, fcfg=bfcfg, families=("kmeans",),
                              corpus=corpus, device="cpu")
    assert res["families"]["kmeans"]["clients_fit"] >= 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        online_routerbench(family="mlp", cfg=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(TINY, steps=1, batch=1, seq=4)
    assert len(train_loop(TINY, steps=1, batch=1, seq=4, log_every=10,
                          device="cpu")[1]) == 1
    for main, argv in ((train.main, ["--arch", "qwen2-1.5b", "--reduced"]),
                       (serve.main, ["--arch", "qwen2-1.5b", "--reduced"]),
                       (train_lm.main, ["--quick"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
