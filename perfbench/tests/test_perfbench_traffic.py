"""The traffic generator is a pure function of (mix, seed, seconds), and
every seed gets the same work in another order."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from perfbench.traffic import gen

MIXES = sorted(p.stem for p in (Path(gen.__file__).parent).glob("*.json"))


def _multiset(s, ks):
    return Counter((s.item(k)[0], s.item(k)[1], round(s.item(k)[3], 6))
                   for k in ks)


@pytest.mark.parametrize("name", MIXES)
def test_mix_files_parse(name):
    mix = gen.load(name)
    assert mix["name"] == name
    assert mix["prompt"]["min"] <= mix["prompt"]["median"] <= mix["prompt"]["max"]
    assert mix["output"]["min"] <= mix["output"]["median"] <= mix["output"]["max"]
    # every request fits its region: the pow2 bucket or prompt + whole chunks
    assert mix["prompt"]["max"] + -(-mix["output"]["max"] // 8) * 8 <= mix["max_seq"]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = gen.load(name)
    a = gen.stream(mix, 2 ** 31 + 17, 20, 32, 1000)
    b = gen.stream(json.loads(json.dumps(mix)), 2 ** 31 + 17, 20, 32, 1000)
    for k in range(40):
        pa, pb = a.item(k), b.item(k)
        assert pa[:2] == pb[:2] and pa[3] == pb[3]
        np.testing.assert_array_equal(pa[2], pb[2])
        np.testing.assert_array_equal(a.tokens(k), b.tokens(k))
    if a.due is not None:
        np.testing.assert_array_equal(a.due, b.due)


def test_open_loop_same_work_other_order():
    mix = gen.load("chat-dense")
    runs = [gen.stream(mix, s, 30, 16, 500) for s in (1, 2, 3_000_000_007)]
    n = int(round(mix["rate_per_s"] * 30))
    for s in runs:
        win = np.nonzero(s.due >= 0)[0]
        assert len(win) == n
        assert s.due[win].max() < 30
        assert s.due.min() == pytest.approx(-mix["warm_s"])
        assert np.all(np.diff(s.due) > 0)
    sets = [_multiset(s, np.nonzero(s.due >= 0)[0]) for s in runs]
    assert sets[0] == sets[1] == sets[2]
    gaps = [np.sort(np.diff(s.due[s.due >= 0])) for s in runs]
    np.testing.assert_allclose(gaps[0][:-1], gaps[1][:-1], atol=0, rtol=0.5)
    order = [[runs[i].item(k)[:2] for k in range(n)] for i in range(2)]
    assert order[0] != order[1]


def test_closed_loop_blocks_hold_the_same_requests():
    """Every copy of the block holds the same requests, each copy in its
    own order; the orders are the mix's, the same for every seed, and the
    seed draws the token ids."""
    mix = gen.load("docs")
    B = mix["block"]
    a, b = (gen.stream(mix, s, 30, 16, 500) for s in (5, 2 ** 31 + 6))
    for blk in range(3):
        ks = range(blk * B, (blk + 1) * B)
        assert _multiset(a, ks) == _multiset(b, ks) == _multiset(a, range(B))
    for k in range(3 * B):
        pa, pb = a.item(k), b.item(k)
        assert pa[:2] == pb[:2] and pa[3] == pb[3]
        np.testing.assert_array_equal(pa[2], pb[2])
    assert [a.item(k)[:2] for k in range(B)] != \
        [a.item(k)[:2] for k in range(B, 2 * B)]
    assert not np.array_equal(a.tokens(0), b.tokens(0))


def test_lengths_follow_the_clipped_lognormal():
    d = {"median": 1024, "sigma": 0.5, "min": 128, "max": 1536}
    q = gen.quantiles(d, 1001)
    assert q.min() >= 128 and q.max() <= 1536
    assert q[500] == 1024
    assert np.all(np.diff(q) >= 0)
    g = gen.exp_gaps(4.0, 4000)
    assert g.mean() == pytest.approx(0.25, rel=0.01)


def test_tokens_below_vocab_and_prompt_long():
    mix = gen.load("chat-moe")
    s = gen.stream(mix, 9, 10, 16, 321)
    for k in range(20):
        t = s.tokens(k)
        assert t.dtype == np.int32 and len(t) == s.item(k)[0]
        assert t.min() >= 1 and t.max() < 321
