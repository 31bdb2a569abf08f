"""The one traffic generator: reads a mix's parameters from
``perfbench/traffic/<mix>.json`` and draws the requests from ``--seed``.

A mix gives the number of closed-loop clients and the distribution of
prompt and answer lengths, each either ``{"fixed": n}`` or
``{"lognormal": {"median": m, "sigma": s}, "min": a, "max": b}``. Every seed
gets the same multiset of lengths (``pool`` quantiles of the distribution,
clipped), dealt in another order, so that the seed changes which request
is long and not how much work a run holds. Prompt tokens are uniform over
``[1, vocab)``; token 0 is the engine's padding.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclasses.dataclass(frozen=True)
class Draw:
    """One request as the benchmark issues it."""
    rid: int
    prompt: np.ndarray          # (prompt_len,) int32
    max_new: int


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def _lengths(spec: dict, pool: int) -> np.ndarray:
    """``pool`` lengths that stand for the distribution ``spec``."""
    if "fixed" in spec:
        return np.full(pool, int(spec["fixed"]), np.int64)
    ln = spec["lognormal"]
    normal = statistics.NormalDist()
    q = [normal.inv_cdf((i + 0.5) / pool) for i in range(pool)]
    xs = ln["median"] * np.exp(ln["sigma"] * np.asarray(q))
    return np.clip(np.rint(xs), spec["min"], spec["max"]).astype(np.int64)


def _seed_words(seed: int, *more: int) -> list[int]:
    return [seed % 2 ** 64, *more]


class Traffic:
    """The request stream of one mix under one seed: request ``k`` (in the
    order the clients ask) has the ``k``-th lengths of the seed's
    permutation of the pool and tokens drawn from (seed, k)."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.clients = int(mix["clients"])
        self.vocab = vocab
        self.seed = seed
        pool = int(mix.get("pool", 1024))
        order = np.random.default_rng(_seed_words(seed, 0)).permutation(pool)
        self.prompt_lens = _lengths(mix["prompt"], pool)[order]
        order = np.random.default_rng(_seed_words(seed, 1)).permutation(pool)
        self.answer_lens = _lengths(mix["answer"], pool)[order]
        self.issued = 0

    def request(self, k: int) -> Draw:
        n = len(self.prompt_lens)
        rng = np.random.default_rng(_seed_words(self.seed, 2, k))
        p = int(self.prompt_lens[k % n])
        prompt = rng.integers(1, self.vocab, p, dtype=np.int64)
        return Draw(k, prompt.astype(np.int32), int(self.answer_lens[k % n]))

    def next_batch(self) -> list[Draw]:
        """The next request of every client (they move in lock step: the
        engine serves a batch whole)."""
        out = [self.request(self.issued + c) for c in range(self.clients)]
        self.issued += self.clients
        return out

    @property
    def longest_prompt(self) -> int:
        return int(self.prompt_lens.max())

    @property
    def longest_answer(self) -> int:
        return int(self.answer_lens.max())
