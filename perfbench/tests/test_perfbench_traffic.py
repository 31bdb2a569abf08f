"""The traffic generator: deterministic by seed, lengths inside the mix's
bounds, the same work for every seed."""

from pathlib import Path

import numpy as np
import pytest

from perfbench.traffic import Traffic, load_mix

# every mix the benchmark has, and a lognormal one of the test's own
LOGNORMAL = {"clients": 16,
             "prompt": {"lognormal": {"median": 512, "sigma": 0.8},
                        "min": 128, "max": 2048},
             "answer": {"lognormal": {"median": 192, "sigma": 0.6},
                        "min": 64, "max": 512},
             "pool": 1024}
MIXES = sorted(p.stem for p in
               (Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))
MIXES += ["lognormal"]
BIG_SEED = 2 ** 31 + 12345


def _mix(name):
    return LOGNORMAL if name == "lognormal" else load_mix(name)


def _bounds(spec):
    if "fixed" in spec:
        return spec["fixed"], spec["fixed"]
    return spec["min"], spec["max"]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    a = Traffic(_mix(mix), 64000, BIG_SEED)
    b = Traffic(_mix(mix), 64000, BIG_SEED)
    for _ in range(3):
        for x, y in zip(a.next_batch(), b.next_batch()):
            assert x.rid == y.rid and x.max_new == y.max_new
            np.testing.assert_array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_and_tokens_in_bounds(mix):
    spec = _mix(mix)
    t = Traffic(spec, 1000, BIG_SEED)
    lo_p, hi_p = _bounds(spec["prompt"])
    lo_a, hi_a = _bounds(spec["answer"])
    for _ in range(4):
        batch = t.next_batch()
        assert len(batch) == spec["clients"]
        for d in batch:
            assert lo_p <= len(d.prompt) <= hi_p
            assert lo_a <= d.max_new <= hi_a
            assert d.prompt.min() >= 1 and d.prompt.max() < 1000


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_holds_the_same_lengths(mix):
    spec = _mix(mix)
    a, b = Traffic(spec, 64000, 1), Traffic(spec, 64000, BIG_SEED)
    assert sorted(a.prompt_lens) == sorted(b.prompt_lens)
    assert sorted(a.answer_lens) == sorted(b.answer_lens)


def test_seeds_differ_in_tokens_and_order():
    a, b = Traffic(LOGNORMAL, 64000, 1), Traffic(LOGNORMAL, 64000, 2)
    assert not np.array_equal(a.prompt_lens, b.prompt_lens)
    x, y = a.request(0), b.request(0)
    assert len(x.prompt) != len(y.prompt) or \
        not np.array_equal(x.prompt, y.prompt)


def test_lognormal_pool_follows_its_median():
    t = Traffic(LOGNORMAL, 64000, 7)
    assert abs(np.median(t.prompt_lens) - 512) <= 2
    assert abs(np.median(t.answer_lens) - 192) <= 2
