"""The decoder family's control engine: the plain reference serving
requests as the program's engine does, greedy, through a K/V cache of its
own. ``perfbench.control`` puts it in the program's place, computed one
precision below the configuration's (``quant="fp8"``); at the reference's
own precision it picks the reference's best token everywhere.
"""

from __future__ import annotations

import dataclasses

MAX_TOKENS_PER_PASS = 8192      # prefill rows per forward pass


def _tree(flat: dict) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


@dataclasses.dataclass
class Handoff:
    requests: list
    tok: object                 # (B, 1) first tokens
    plen: int
    max_new: int
    groups: list                # (rows, prompt length, per-layer (K, V))


@dataclasses.dataclass
class Answer:
    rid: int
    tokens: list


class ReferenceEngine:
    """The reference (``Reference(c, w, quant)``) serving requests as the
    program's engine does: the first token from the prompt pass, then
    greedy steps, each against a K/V cache in fp32 that it fills itself.
    Requests of one prompt length go together, so no position is padding.
    Its weights (``params_home``) are written by the harness like the
    program's."""

    def __init__(self, c: dict, device, quant: str | None = "fp8"):
        import torch
        from perfbench.reference.model import Reference
        from perfbench.reference.weights import leaf_shapes
        self.c = c
        self.device = torch.device(device)
        self.tracer = None
        flat = {p: torch.empty(s, dtype=torch.bfloat16, device=self.device)
                for p, s in leaf_shapes(c).items()}
        self.params_home = _tree(flat)
        self.ref = Reference(c, flat, quant=quant)

    def _attend(self, h, l: int, kv: tuple, pos: int):
        """Attention of ``h`` (B, n, d) at positions ``pos`` on, its K/V
        written into ``kv`` first."""
        import torch
        c, ref, seg = self.c, self.ref, self.ref.seg
        B, n, d = h.shape
        Hq, Hkv, dh = (c["num_attention_heads"], c["num_key_value_heads"],
                       c["head_dim"])
        proj = {w: ref._mm(h, ref._leaf(seg, "attn", w, layer=l)
                           .reshape(d, -1)).view(B, n, -1, dh)
                for w in ("w_q", "w_k", "w_v")}
        K, V = kv
        K[:, pos:pos + n] = ref._rope(proj["w_k"], pos)
        V[:, pos:pos + n] = proj["w_v"]
        q = ref._rope(proj["w_q"], pos).view(B, n, Hkv, Hq // Hkv, dh)
        T = pos + n
        s = torch.einsum("bnkgd,btkd->bkgnt", q, K[:, :T]) / dh ** 0.5
        keys = torch.arange(T, device=h.device)
        at = torch.arange(pos, T, device=h.device)[:, None]
        mask = keys[None, :] <= at
        window = c.get("sliding_window") or 0
        if window:
            mask &= keys[None, :] > at - window
        s = s.masked_fill(~mask, float("-inf"))
        ctx = torch.einsum("bkgnt,btkd->bnkgd", torch.softmax(s, -1),
                           V[:, :T]).reshape(B, n, Hq * dh)
        w_o = ref._leaf(seg, "attn", "w_o", layer=l).reshape(Hq * dh, d)
        return ref._mm(ctx, w_o)

    def _last_logits(self, toks, kv: list, pos: int):
        """fp32 logits (B, vocab) at the last of ``toks`` (B, n), which sit
        at positions ``pos`` on."""
        from perfbench.reference.model import fp32_products
        ref, seg = self.ref, self.ref.seg
        with fp32_products():
            x = ref.w[("embed", "tok")][toks].float()
            for l in range(self.c["num_hidden_layers"]):
                x = x + self._attend(
                    ref._norm(x, ref._leaf(seg, "ln1", layer=l)), l, kv[l],
                    pos)
                x = x + ref._ffn(
                    ref._norm(x, ref._leaf(seg, "ln2", layer=l)), l)
            return ref._mm(ref._norm(x[:, -1], ref._leaf("final_norm")),
                           ref._leaf("embed", "out"))

    def prefill(self, requests: list) -> Handoff:
        import numpy as np
        import torch
        c = self.c
        max_new = max(r.max_new for r in requests)
        first = torch.empty((len(requests), 1), dtype=torch.long,
                            device=self.device)
        by_len: dict = {}
        for i, r in enumerate(requests):
            by_len.setdefault(len(r.prompt), []).append(i)
        groups = []
        with torch.no_grad():
            for plen, rows in by_len.items():
                shape = (len(rows), plen + max_new, c["num_key_value_heads"],
                         c["head_dim"])
                kv = [tuple(torch.zeros(shape, device=self.device)
                            for _ in range(2))
                      for _ in range(c["num_hidden_layers"])]
                per = max(1, MAX_TOKENS_PER_PASS // plen)
                for a in range(0, len(rows), per):
                    part = rows[a:a + per]
                    toks = torch.as_tensor(
                        np.stack([requests[i].prompt for i in part]),
                        dtype=torch.long, device=self.device)
                    view = [(K[a:a + per], V[a:a + per]) for K, V in kv]
                    first[part] = self._last_logits(toks, view, 0) \
                        .argmax(-1, keepdim=True)
                groups.append((rows, plen, kv))
        return Handoff(requests, first, max(by_len), max_new, groups)

    def decode(self, handoff: Handoff) -> list:
        import torch
        outs = [[] for _ in handoff.requests]
        with torch.no_grad():
            for rows, plen, kv in handoff.groups:
                tok = handoff.tok[rows]
                for s in range(handoff.max_new):
                    tok = self._last_logits(tok, kv, plen + s) \
                        .argmax(-1, keepdim=True)
                    for i, t in zip(rows, tok.view(-1).tolist()):
                        outs[i].append(t)
        return [Answer(r.rid, outs[i][:r.max_new])
                for i, r in enumerate(handoff.requests)]
