"""The traffic generator: a seed gives the same stream every time; every
seed offers the same requests, size for size and in the same order, and
only the token ids move with it; each block is the stratified set; the
lengths follow their distribution."""
import numpy as np
import pytest

import bench_tiny
from bench_tiny import torch_cpu  # noqa: F401 (fixture)
from benchkit import samplers, traffic

MIX = bench_tiny.TINY_MIXES["tiny-closed"]


def _stream(seed, n=16, mix=MIX):
    s = traffic.Stream(mix, 128, seed, "measured")
    return [s[i] for i in range(n)]


def _sizes(items):
    return [(len(x.prompt), x.max_new) for x in items]


def test_same_seed_same_stream():
    a, b = _stream(2 ** 33 + 5), _stream(2 ** 33 + 5)
    assert _sizes(a) == _sizes(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("seeds", [(3, 4), (1, 2 ** 32 + 1)])
def test_seeds_share_the_requests_and_their_order(seeds):
    a, b = (_stream(s) for s in seeds)
    assert _sizes(a) == _sizes(b)
    assert [x.prompt[0] for x in a] != [x.prompt[0] for x in b]


def test_each_block_is_the_stratified_set_in_a_new_order():
    items = _stream(5)
    blocks = [_sizes(items[:8]), _sizes(items[8:])]
    assert sorted(blocks[0]) == sorted(blocks[1])
    assert blocks[0] != blocks[1]


def test_the_pairing_is_fixed_and_spans_both_ranges():
    s = traffic.Stream(MIX, 128, 9, "measured")
    assert sorted(_sizes([s[i] for i in range(8)])) == sorted(s.sizes)
    plens, outs = zip(*s.sizes)
    assert sorted(plens) == samplers.bounded_pareto(
        (np.arange(8) + 0.5) / 8, 4, 12, 1.2).tolist()
    # not paired in rank order: the longest prompt need not bring the
    # longest output
    assert list(outs) != sorted(outs)


def test_stratified_lengths_follow_the_distribution():
    u = (np.arange(4000) + 0.5) / 4000
    x = samplers.bounded_pareto(u, 32, 2048, 1.2)
    assert x.min() == 32 and x.max() <= 2048
    assert 50 <= np.median(x) <= 60 and 95 <= x.mean() <= 125


def test_unknown_length_kind_is_refused():
    mix = dict(MIX, output_len={"kind": "uniform", "lo": 4, "hi": 10})
    with pytest.raises(ValueError, match="uniform"):
        traffic.Stream(mix, 128, 1, "measured")
