"""The metric arithmetic on synthetic timelines."""
import math

import numpy as np
import pytest

from perfbench import bench, costs, reduce

M = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2,
     "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
     "vocab_size": 10}


def _rec(req, steps, t0=10.0, t1=20.0, seconds=10.0, trace=None):
    n = len(req["P"])
    full = {"k": list(range(n)), "rid": list(range(n)),
            "submit_profiled": [False] * n, "status": ["DONE"] * n}
    full.update(req)
    return {"loop": "open", "t0": t0, "t1": t1, "seconds": seconds,
            "req": {k: np.asarray(v) for k, v in full.items()},
            "steps": steps, "trace": trace, "models": [M], "chunk": 2,
            "slots": 4, "page_size": 2}


def test_ttft_counts_a_stalled_request_with_its_wait_so_far():
    nan = math.nan
    rec = _rec({"due": [9.0, 11.0, 12.0, 19.5], "t_first": [9.5, 11.2, nan, nan],
                "t_done": [nan] * 4, "O": [4] * 4, "P": [3] * 4,
                "t_submit": [9.0, 11.0, 12.0, 19.5], "submit_s": [0.0] * 4},
               {"t_start": [], "t_end": [], "rows": [], "profiled": []},
               t1=20.5)
    # the warm request (due 9) is not in the window; the queued ones count
    # to the window's end (20.5)
    np.testing.assert_allclose(sorted(reduce.ttft_ms(rec)),
                               [200.0, 1000.0, 8500.0])


def test_tpot_and_rate_count_completions_in_the_window():
    nan = math.nan
    rec = _rec({"due": [5.0, 9.0, 11.0, 12.0], "t_first": [6.0, 9.5, 11.5, 13.0],
                "t_done": [8.0, 10.5, 15.5, nan], "O": [3, 5, 9, 4],
                "P": [3] * 4, "t_submit": [5.0, 9.0, 11.0, 12.0],
                "submit_s": [0.0] * 4},
               {"t_start": [], "t_end": [], "rows": [], "profiled": []})
    np.testing.assert_allclose(sorted(reduce.tpot_ms(rec)), [250.0, 500.0])
    assert reduce.output_tok_s(rec) == pytest.approx((5 + 9) / 10.0)
    assert reduce.p90([1, 2, 3, 4, 5, 6, 7, 8, 9, 10]) == pytest.approx(9.1)
    assert reduce.p90([]) is None


def test_union_of_intervals_and_idle_share():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert reduce.union_length(ivs, 0.0, 10.0) == pytest.approx(3.0)
    assert reduce.union_length(ivs, 1.5, 3.5) == pytest.approx(1.0)
    assert reduce.merged(ivs) == [[0.0, 2.0], [3.0, 4.0]]
    trace = {"ops": [("k", 0.0, 1.0), ("k", 0.5, 2.0), ("k", 3.0, 4.0)],
             "steps": [(0.0, 2.5), (2.5, 5.0)], "spans": [], "step_ids": []}
    rec = _rec({"P": [], "O": []}, {}, trace=trace)
    assert reduce.idle_share_pct(rec) == pytest.approx(40.0)
    rec["trace"] = None
    assert reduce.idle_share_pct(rec) is None


def test_step_metrics_leave_out_profiled_and_warm_steps():
    steps = {"t_start": [9.0, 10.0, 11.0, 12.0], "t_end": [10.0, 10.5, 11.5, 13.0],
             "rows": [1, 3, 5, 99], "profiled": [False, False, False, True]}
    rec = _rec({"P": [4], "O": [5], "step_admit": [1], "step_done": [3],
                "model": [0], "t_first": [10.5], "t_done": [math.nan],
                "due": [10.0], "t_submit": [10.0], "submit_s": [0.001]},
               steps)
    assert reduce.mean_step_ms(rec) == pytest.approx(500.0)
    assert reduce.mean_rows(rec) == pytest.approx(4.0)
    assert reduce.mean_submit_ms(rec) == pytest.approx(1.0)
    # prefill of 4 tokens in step 1, decode passes at positions 4, 5 in step
    # 1 and 6, 7 in step 2 (O = 5: passes 0 .. 3)
    f = reduce.step_flops(rec)
    assert f[0] == 0 and f[3] == 0
    assert f[1] == costs.prefill_flops(M, 4) + costs.decode_passes_flops(
        M, 4, 2)
    assert f[2] == costs.decode_passes_flops(M, 6, 2)
    assert reduce.mfu_pct(rec) == pytest.approx(
        (f[1] + f[2]) / (1.0 * costs.PEAK_BF16_FLOPS) * 100)


def test_roofline_needs_the_timeline_launch_count():
    steps = {"t_start": [0.0], "t_end": [1.0], "rows": [1], "profiled": [True]}
    req = {"P": [3], "O": [4], "step_admit": [0], "step_done": [-1],
           "model": [0], "t_first": [1.0], "t_done": [math.nan], "due": [0.0],
           "t_submit": [0.0], "submit_s": [0.0]}
    # chunk 2 → 2 passes × 2 layers = 4 launches expected
    ops = [("void decode_paged_kernel<bf16>", 0.1 * i, 0.1 * i + 0.01)
           for i in range(4)] + [("decode_merge_kernel", 0.5, 0.51)]
    rec = _rec(req, steps, trace={"ops": ops, "steps": [(0.0, 1.0)],
                                  "spans": [], "step_ids": [0]})
    nv = [[4, 1, 1, 1], [5, 1, 1, 1]]
    least = sum(2 * costs.least_seconds(*costs.paged_decode_cost(M, v, 2))
                for v in nv)
    got = reduce.roofline_pct(rec, "decode_paged", ("decode_merge",))
    assert got == pytest.approx(least / 0.05 * 100)
    rec["trace"]["ops"] = ops[1:]
    assert reduce.roofline_pct(rec, "decode_paged", ("decode_merge",)) is None


def test_every_metric_has_a_reader_that_skips_what_it_cannot_read():
    spec = bench.load_spec()
    rec = _rec({"P": [], "O": [], "due": [], "t_first": [], "t_done": [],
                "t_submit": [], "submit_s": [], "step_admit": [],
                "step_done": [], "model": []},
               {"t_start": [], "t_end": [], "rows": [], "profiled": []})
    rec["setup_s"] = 1.0
    for m in spec["end_to_end"] + spec["per_layer"]:
        v = bench.reader(m["name"])(rec)
        assert v is None or isinstance(v, float), m["name"]
