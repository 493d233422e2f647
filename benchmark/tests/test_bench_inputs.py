"""The traffic generators are reproducible from the seed, and keep to the
ranges their traffic files give."""
from __future__ import annotations

import numpy as np
import pytest

from benchmark.runners import common
from benchmark.harness import textgen
from benchmark.harness.registry import Cell
from benchmark.run import Ctx

SEEDS = [0, 1, 2**31 + 11, 2**40 + 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_texts_prompts_and_seeds_repeat(seed):
    assert textgen.text(seed, 3, 4) == textgen.text(seed, 3, 4)
    np.testing.assert_array_equal(textgen.prompt(seed, 1), textgen.prompt(seed, 1))
    assert textgen.request_seed(seed, 5) == textgen.request_seed(seed, 5)
    np.testing.assert_array_equal(textgen.poisson_arrivals(seed, 2.0, 50),
                                  textgen.poisson_arrivals(seed, 2.0, 50))
    assert textgen.text(seed, 3, 4) != textgen.text(seed, 3, 5)
    assert textgen.request_seed(seed, 5) != textgen.request_seed(seed + 1, 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_ranges(seed):
    for i in range(30):
        n = len(textgen.text(seed, i, lo=40, hi=700).encode())
        assert 40 <= n <= 701
        p = textgen.prompt(seed, i, lo_s=10.0, hi_s=25.0)
        assert p.dtype == np.float32 and p.shape[0] == 1
        assert 10.0 * 44100 - 1 <= p.shape[1] <= 25.0 * 44100
        assert np.abs(p).max() < 1.0
        assert 0 <= textgen.request_seed(seed, i) < 2**32
    gaps = np.diff(textgen.poisson_arrivals(seed, 4.0, 4000))
    assert abs(gaps.mean() - 0.25) < 0.02


@pytest.mark.parametrize("workload", ["oneshot-b8-closed16", "stream-b8-closed8"])
def test_a_clients_requests_do_not_depend_on_the_others(workload):
    """Client c's j-th request is a function of (seed, c, j): the closed
    loop's interleaving cannot change what is asked."""
    import argparse

    cell = Cell(workload)
    ctx = Ctx(cell, argparse.Namespace(seed=99, seconds=1, trace=0), "cpu", 0.0)
    pool = common.voices(ctx)
    a = [common.request(ctx, pool, c, j) for c in range(3) for j in range(5)]
    b = [common.request(ctx, pool, c, j) for j in range(5) for c in range(3)]
    key = lambda r: (r["client"], r["index"])  # noqa: E731
    for x, y in zip(sorted(a, key=key), sorted(b, key=key)):
        assert x["text"] == y["text"] and x["seed"] == y["seed"] and x["voice"] == y["voice"]
        np.testing.assert_array_equal(x["speaker"], y["speaker"])
    fresh = [r["voice"] < 0 for r in a]
    every = cell.traffic["fresh_every"]
    assert sum(fresh) == (len(a) // every if every else 0)
