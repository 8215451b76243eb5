"""The port's span log (``repro_torch.tracing``) and the engine's three
names in it, on the CPU with tiny models: ``engine.prefill`` once per
(lane, bucket) admitted in a step (once per request on a uniform lane),
``engine.decode`` once per busy lane per step, ``engine.first_token``
once per admitted request, inside its prefill. Nothing is recorded
without a profiler, the tokens do not change with one, the profile
holds no event of the log's, and the ring stays bounded."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.config import ModelConfig
from repro_torch.serve.engine import EngineConfig, ServeEngine, next_pow2
from repro_torch.serve.gateway import make_pool_model

torch.set_num_threads(1)

TINY = ModelConfig(name="tiny-trace", arch_type="dense", n_layers=2,
                   d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab=97,
                   head_dim=16)
#: (lane, prompt length, max_new): three of lane 0's first four share
#: bucket 8, so a paged admission coalesces them (batch 4, one pad row)
REQS = [(0, 5, 5), (1, 3, 3), (0, 9, 8), (0, 6, 6), (1, 12, 4), (0, 7, 7),
        (1, 4, 5), (0, 3, 4), (1, 6, 9)]
CONFIGS = {
    "paged": EngineConfig(slots=4, max_seq=32, chunk=4, page_size=4),
    "uniform": EngineConfig(slots=4, max_seq=32, chunk=4, page_size=None),
    "spec": EngineConfig(slots=4, max_seq=32, chunk=4, page_size=4,
                         spec_k=2),
}


def _engine(ecfg):
    pool = [make_pool_model(f"m{i}", TINY, 0.1, gen=i, device="cpu")
            for i in range(2)]
    eng = ServeEngine(pool, ecfg, device="cpu")
    rng = np.random.default_rng(0)
    rids = {}
    for lane, n, max_new in REQS:
        rids[eng.submit(lane, rng.integers(1, TINY.vocab, n), max_new)] = (
            lane, n)
    return eng, rids


def _since(t0_ns):
    return [r for r in tracing.snapshot() if r[1] >= t0_ns]


def _run(ecfg, profiled):
    """Step the engine to the end; per step the log's new records and the
    rids it finished; the tokens."""
    eng, rids = _engine(ecfg)
    steps, tokens = [], {}
    for _ in range(200):
        if not eng.busy:
            break
        t0 = time.perf_counter_ns()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                fin = eng.step()
            assert not [e.name for e in prof.events()
                        if e.name.startswith("engine.")]
        else:
            fin = eng.step()
        steps.append((_since(t0), [rid for rid, _ in fin]))
        tokens.update(fin)
    assert not eng.busy
    return rids, steps, tokens


@pytest.mark.parametrize("mode", list(CONFIGS))
def test_engine_spans_and_marks_follow_its_steps(mode):
    ecfg = CONFIGS[mode]
    _, plain_steps, plain = _run(ecfg, profiled=False)
    assert all(log == [] for log, _ in plain_steps)     # no profiler, no log
    rids, steps, tokens = _run(ecfg, profiled=True)
    assert sorted(tokens) == sorted(plain)
    for rid in plain:
        np.testing.assert_array_equal(tokens[rid], plain[rid])

    admitted, done = {}, set()
    for n, (log, fin) in enumerate(steps):
        prefills = [r for r in log if r[0] == "engine.prefill"]
        decodes = [r for r in log if r[0] == "engine.decode"]
        marks = [r for r in log if r[0] == "engine.first_token"]
        assert len(prefills) + len(decodes) + len(marks) == len(log)
        assert all(r[1] == r[2] for r in marks)
        seen = set()
        for _, a, b, at in prefills:
            inside = [m[3]["rid"] for m in marks if a <= m[1] <= b]
            lens = [rids[rid][1] for rid in inside]
            assert inside and {rids[rid][0] for rid in inside} == {
                at["model"]}
            assert at["rows"] == len(inside)
            assert at["tokens"] == sum(lens)
            assert {next_pow2(s) for s in lens} == {at["bucket"]}
            if ecfg.page_size:
                assert at["batch"] == next_pow2(len(inside))
                assert (at["model"], at["bucket"]) not in seen
                seen.add((at["model"], at["bucket"]))
            else:
                assert at["rows"] == at["batch"] == 1
            admitted.update((rid, n) for rid in inside)
        assert len(marks) == sum(at["rows"] for *_, at in prefills)
        if ecfg.spec_k:
            assert decodes == []
        else:
            busy = {}
            for rid in admitted:
                if rid not in done:
                    busy[rids[rid][0]] = busy.get(rids[rid][0], 0) + 1
            assert {at["model"]: at["rows"] for *_, at in decodes} == busy
            assert all(at["passes"] == ecfg.chunk for *_, at in decodes)
            # each lane's admissions end before its decode begins
            for *_, b, at in prefills:
                assert all(b <= d[1] for d in decodes
                           if d[3]["model"] == at["model"])
        done.update(fin)
    assert sorted(admitted) == sorted(rids)


def test_log_is_off_without_a_profiler_and_bounded_with_one():
    assert tracing.span("a") is tracing.span("b")
    t0 = time.perf_counter_ns()
    with tracing.span("test.off"):
        tracing.mark("test.off")
    assert _since(t0) == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("test.span", k=1):
            time.sleep(0.001)
        (name, a, b, attrs), = _since(t0)
        assert (name, attrs) == ("test.span", {"k": 1}) and b - a >= 1e6
        for i in range(tracing.RING_LEN + 10):
            tracing.mark("test.mark", i=i)
    log = tracing.snapshot()
    assert len(log) == tracing.RING_LEN
    assert log[0][3] == {"i": 10}
    assert log[-1][:1] + log[-1][3:] == ("test.mark", {"i": len(log) + 9})
