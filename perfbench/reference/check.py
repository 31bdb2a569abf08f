"""The comparison that decides ``correct`` for a served model.

For each sampled request the reference runs once over its prompt followed
by the tokens the program served (all but the last), and reads, at every
position that produced a served token, how far that token's logit lies
below the reference's best there. Two numbers are compared: the widest
such gap over the sample, since greedy decoding in the program's
precision should only ever pick a token the reference nearly ties with;
and the mean gap over the sample's served tokens, since such near-ties
are rare.

``control_gaps`` reads the same positions for the control: the gap of the
token that the control's own logits put first.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_TOKENS_PER_PASS = 8192      # reference activations per forward pass


def _passes(items: list) -> list[list[int]]:
    """Indices of ``items`` grouped so that each pass holds at most
    ``MAX_TOKENS_PER_PASS`` positions (one long item alone)."""
    groups, cur, size = [], [], 0
    for i, (prompt, served) in enumerate(items):
        n = len(prompt) + len(served) - 1
        if cur and size + n > MAX_TOKENS_PER_PASS:
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    if cur:
        groups.append(cur)
    return groups


def _inputs(items: list, idx: list[int]) -> tuple[list, list]:
    seqs, want = [], []
    for i in idx:
        prompt, served = items[i]
        seqs.append(list(map(int, prompt)) + list(map(int, served[:-1])))
        want.append(list(range(len(prompt) - 1,
                               len(prompt) - 1 + len(served))))
    return seqs, want


def served_gaps(ref, items: list) -> list[np.ndarray]:
    """Per item (prompt, served tokens): the gap of each served token
    under the reference's logits (``ref.logits``, a family's
    ``reference``) at the position that produced it."""
    out: list = [None] * len(items)
    for idx in _passes(items):
        seqs, want = _inputs(items, idx)
        for i, lg in zip(idx, ref.logits(seqs, want)):
            served = torch.as_tensor(list(map(int, items[i][1])),
                                     device=lg.device)
            gap = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
            out[i] = gap.cpu().numpy()
    return out


def control_gaps(ref, ctl, items: list) -> list[np.ndarray]:
    """Per item: at each position that produced a served token, the
    reference's gap of the token the control puts first there."""
    out: list = [None] * len(items)
    for idx in _passes(items):
        seqs, want = _inputs(items, idx)
        for i, lr, lc in zip(idx, ref.logits(seqs, want),
                             ctl.logits(seqs, want)):
            pick = lc.argmax(-1)
            gap = lr.max(-1).values - lr.gather(1, pick[:, None])[:, 0]
            out[i] = gap.cpu().numpy()
    return out


def widest(gaps: list[np.ndarray]) -> float:
    return float(max(g.max() for g in gaps))


def mean(gaps: list[np.ndarray]) -> float:
    """The mean gap over every served token of the sample. A near-tie that
    rounding flips sets the widest gap alone; a computation that departs
    from the reference moves many tokens, and this with them."""
    return float(np.concatenate(gaps).mean())


def sample(done: list, seed: int, tokens: int) -> list:
    """Requests (draw, served tokens) from ``done``, drawn from ``seed``:
    the longest (prompt and answer) first, then others in the seed's
    order until ``tokens`` served tokens are in the sample."""
    if not done:
        return []
    longest = max(range(len(done)),
                  key=lambda i: (len(done[i][0].prompt) + done[i][0].max_new,
                                 -i))
    rest = [i for i in range(len(done)) if i != longest]
    order = np.random.default_rng([seed % 2 ** 64, 3]).permutation(len(rest))
    picked, served = [longest], len(done[longest][1])
    for j in order:
        if served >= tokens:
            break
        picked.append(rest[j])
        served += len(done[rest[j]][1])
    return [done[i] for i in picked]
