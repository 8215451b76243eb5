"""The readers of the port's own spans (``spans.py``): on a synthetic
record and a synthetic span log, the clock offset of each traced step
(from its ends: the profiler's start of a session's first step is late),
the operations each span holds and every reader's value by hand; nothing
read from a record without traced steps, or from a port without the span
log, whatever the log holds; and a traced CPU run of the tiny chat cell
reads the host-clock span metrics and leaves the device ones out."""
import math
import sys

import numpy as np
import pytest
from test_perfbench_harness import tiny_parts

from perfbench import bench, spans
from perfbench import run as R

M0 = {"num_hidden_layers": 2}
M1 = {"num_hidden_layers": 3}
NEW = ["engine.prefill_us_per_token.chat", "engine.prefill_us_per_token.docs",
       "engine.decode_pass_ms.chat", "engine.decode_ops_per_layer.chat",
       "engine.prefill_ops_per_layer.docs", "device.prefill_idle_share.chat",
       "engine.first_token_hold_ms.chat"]
#: profiler clock − host clock in each traced step (steps 2 and 3)
OFF = (123.456, 123.4561)
#: the profiler's start of the first traced step is this late
ENTRY = 0.0009


def _ns(t):
    return int(round(t * 1e9))


#: the port's log, on the host clock (s): (name, t0, t1, attrs)
LOG = [
    # in untraced step 1: left out
    ("engine.prefill", 11.1, 11.2, {"model": 0, "rows": 1, "batch": 1,
                                    "bucket": 8, "tokens": 5}),
    ("engine.first_token", 11.2, 11.2, {"rid": 0, "model": 0}),
    # traced step 2, [20.0, 21.0]
    ("engine.first_token", 20.3, 20.3, {"rid": 1, "model": 0}),
    ("engine.first_token", 20.3, 20.3, {"rid": 2, "model": 0}),
    ("engine.prefill", 20.1, 20.3, {"model": 0, "rows": 2, "batch": 2,
                                    "bucket": 128, "tokens": 200}),
    ("engine.decode", 20.4, 20.8, {"model": 0, "rows": 3, "passes": 8}),
    # traced step 3, [22.0, 23.0]
    ("engine.first_token", 22.5, 22.5, {"rid": 3, "model": 1}),
    ("engine.prefill", 22.2, 22.5, {"model": 1, "rows": 1, "batch": 1,
                                    "bucket": 64, "tokens": 50}),
    ("engine.decode", 22.6, 22.7, {"model": 1, "rows": 1, "passes": 8}),
    # after the last traced step: left out
    ("engine.decode", 23.1, 23.2, {"model": 1, "rows": 1, "passes": 8}),
]


def _on_trace(step, t):
    return t + OFF[step - 2]


def _ops():
    """(name, start, end) on the profiler's clock."""
    p, d = [], []
    for a in (20.12, 20.15, 20.2):                  # in step 2's prefill
        p.append(("gemm", _on_trace(2, a), _on_trace(2, a + 0.02)))
    for a in (20.45, 20.5, 20.6, 20.7):             # in its decode
        d.append(("decode_paged_kernel", _on_trace(2, a),
                  _on_trace(2, a + 0.01)))
    p.append(("gemm", _on_trace(3, 22.3), _on_trace(3, 22.4)))
    d.append(("decode_paged_kernel", _on_trace(3, 22.65),
              _on_trace(3, 22.66)))
    neither = [
        # starts before step 3's prefill and runs into it: not the span's
        ("copy", _on_trace(3, 22.15), _on_trace(3, 22.25)),
        ("copy", _on_trace(2, 20.35), _on_trace(2, 20.36)),
    ]
    return p, d, neither


def _rec():
    p, d, neither = _ops()
    t_start, t_end = [10.0, 11.0, 20.0, 22.0], [10.5, 11.5, 21.0, 23.0]
    nan = math.nan
    return {
        "steps": {"t_start": t_start, "t_end": t_end, "rows": [1] * 4,
                  "profiled": [False, False, True, True]},
        "trace": {"ops": p + d + neither, "spans": [],
                  "steps": [(_on_trace(2, t_start[2]) + ENTRY,
                             _on_trace(2, t_end[2])),
                            (_on_trace(3, t_start[3]), _on_trace(3, t_end[3]))],
                  "step_ids": [2, 3]},
        "req": {"rid": np.asarray([0, 1, 2, 3, 4]),
                "t_first": np.asarray([11.5, 21.0, 21.0, 23.0, nan])},
        "models": [M0, M1]}


@pytest.fixture
def log(monkeypatch):
    from repro_torch import tracing
    recs = [(n, _ns(a), _ns(b), at) for n, a, b, at in LOG]
    monkeypatch.setattr(tracing, "snapshot", lambda: list(recs))
    return recs


def test_spans_take_each_traced_steps_clock_offset(log):
    rec = _rec()
    got = spans.program_spans(rec)
    assert [(s.name, s.t0) for s in got] == [
        (n, pytest.approx(a, abs=1e-9)) for n, a, *_ in LOG[2:-1]]
    for s in got:
        step = 2 if s.t0 < 21.5 else 3
        assert s.offset == pytest.approx(OFF[step - 2], abs=1e-9)
    p, d, _ = _ops()
    pre = spans.program_spans(rec, spans.PREFILL)
    dec = spans.program_spans(rec, spans.DECODE)
    assert sorted(spans.ops_in(rec, pre)) == sorted(p)
    assert sorted(spans.ops_in(rec, dec)) == sorted(d)


def test_each_reader_reads_its_hand_computed_value(log):
    rec = _rec()
    got = {n: bench.reader(n)(rec) for n in NEW}
    want = {
        # (0.2 + 0.3) s over 250 tokens
        "engine.prefill_us_per_token.chat": 0.5 / 250 * 1e6,
        "engine.prefill_us_per_token.docs": 0.5 / 250 * 1e6,
        # (0.4 + 0.1) s over 16 passes
        "engine.decode_pass_ms.chat": 0.5 / 16 * 1e3,
        # 5 launches over 8 × 2 + 8 × 3 layer passes
        "engine.decode_ops_per_layer.chat": 5 / 40,
        # 4 launches over 2 + 3 layers
        "engine.prefill_ops_per_layer.docs": 4 / 5,
        # busy: 3 × 0.02 in step 2's 0.2 s; 0.05 (the straddling copy's
        # part) + 0.1 in step 3's 0.3 s
        "device.prefill_idle_share.chat": (1 - (0.06 + 0.15) / 0.5) * 100,
        # rids 1, 2: 21.0 − 20.3; rid 3: 23.0 − 22.5
        "engine.first_token_hold_ms.chat": (0.7 + 0.7 + 0.5) / 3 * 1e3,
    }
    for n in NEW:
        assert got[n] == pytest.approx(want[n], rel=1e-6), n


def _untraced(rec):
    rec["trace"] = None


def _no_steps(rec):
    rec["trace"]["steps"], rec["trace"]["step_ids"] = [], []


def _steps_mismatch(rec):
    rec["trace"]["step_ids"] = [1, 2, 3]


def _no_log(rec):
    pass


@pytest.mark.parametrize("case", [_untraced, _no_steps, _steps_mismatch,
                                  _no_log], ids=lambda f: f.__name__[1:])
def test_readers_read_nothing_they_cannot_place(log, monkeypatch, case):
    rec = _rec()
    case(rec)
    if case is _no_log:         # a port without the span log
        import repro_torch
        monkeypatch.delattr(repro_torch, "tracing")
        monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert spans.program_spans(rec) == []
    for n in NEW:
        assert bench.reader(n)(rec) is None, n


def test_device_readers_need_device_operations(log):
    rec = _rec()
    rec["trace"]["ops"] = []
    got = {n: bench.reader(n)(rec) for n in NEW}
    for m in bench.load_spec()["per_layer"]:
        if m["name"] in NEW:
            assert (got[m["name"]] is None) == (m["source"] ==
                                                "device_trace"), m["name"]


def test_traced_cpu_run_reads_the_span_metrics():
    got = R.run_cell(tiny_parts(), 2 ** 31 + 9, 3.0, True, "cpu")
    res, rec = got["result"], got["record"]
    assert res["correct"]
    m = res["metrics"]
    for name in ("engine.prefill_us_per_token.chat",
                 "engine.decode_pass_ms.chat",
                 "engine.first_token_hold_ms.chat"):
        assert m[name]["value"] > 0, name
    # the CPU run's trace holds no device operation
    assert not {"engine.decode_ops_per_layer.chat",
                "device.prefill_idle_share.chat"} & set(m)
    # every span lies inside a traced step on both clocks, within 0.1 ms
    # and, at the start, the step's late entry on the profiler's clock
    got = spans.program_spans(rec)
    assert {s.name for s in got} == {spans.PREFILL, spans.DECODE,
                                     spans.FIRST}
    tr, st = rec["trace"], rec["steps"]
    inside = 0
    for j, (a, b) in zip(tr["step_ids"], tr["steps"]):
        late = (a - st["t_start"][j]) - (b - st["t_end"][j])
        for s in got:
            lo, hi = s.mapped
            if st["t_start"][j] <= s.t0 <= st["t_end"][j]:
                assert a - late - 1e-4 <= lo and hi <= b + 1e-4
                inside += 1
    assert inside == len(got)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return torch.device("cuda", 0)


def test_decode_spans_hold_every_paged_launch_on_the_card(cuda):
    """On the card, a traced tiny run's ``engine.decode`` spans hold each
    kernel #3 launch of the traced steps, passes × layers of them, and no
    device operation carries a name of the port's log."""
    got = R.run_cell(tiny_parts(), 13, 3.0, True, cuda)
    res, rec = got["result"], got["record"]
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert {"engine.decode_ops_per_layer.chat",
            "device.prefill_idle_share.chat"} <= set(m)
    dec = spans.program_spans(rec, spans.DECODE)
    paged = [op for op in spans.ops_in(rec, dec) if "decode_paged" in op[0]]
    assert len(paged) == sum(
        s.attrs["passes"] * rec["models"][s.attrs["model"]]
        ["num_hidden_layers"] for s in dec) > 0
    assert not [op for op in rec["trace"]["ops"]
                if op[0].startswith("engine.")]
