"""The deepseek family's control engine: its plain reference
(``perfbench.reference.deepseek``) serving requests as the program's
engine does, greedy, through a cache of its own that holds each
position's KV latent (c and the turned k_rope, fp32), from which every
step up-projects the keys and values again (the reference's plain form,
not the program's absorbed one). ``perfbench.control`` puts it in the
program's place, computed one precision below the configuration's
(``quant="fp8"``); at the reference's own precision it picks the
reference's best token everywhere.
"""

from __future__ import annotations

MAX_TOKENS_PER_PASS = 8192      # prefill rows per forward pass


class DeepSeekEngine:
    """The reference (``Reference(c, w, quant)``) serving requests: the
    first token from the prompt pass, then greedy steps against its latent
    cache. Requests of one prompt length go together, so no position is
    padding. Its weights (``params_home``) are written by the harness like
    the program's."""

    def __init__(self, c: dict, device, quant: str | None = "fp8"):
        import torch
        from perfbench.reference.deepseek import Reference, leaf_shapes
        from perfbench.reference.engine import _tree
        self.c = c
        self.device = torch.device(device)
        self.tracer = None
        flat = {p: torch.empty(s, dtype=torch.bfloat16, device=self.device)
                for p, s in leaf_shapes(c).items()}
        self.params_home = _tree(flat)
        self.ref = Reference(c, flat, quant=quant)

    def _last_logits(self, toks, kv: list, pos: int):
        """fp32 logits (B, vocab) at the last of ``toks`` (B, n), which sit
        at positions ``pos`` on; their latents go into ``kv``."""
        from perfbench.reference.model import fp32_products
        ref = self.ref
        with fp32_products():
            x = ref.w[("embed", "tok")][toks].float()
            for (seg, i, moe), cache in zip(ref.layers, kv):
                x = ref.block(x, (seg, i), moe, cache, pos)
            return ref.head(x[:, -1])

    def prefill(self, requests: list):
        import numpy as np
        import torch
        from perfbench.reference.engine import Handoff
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
                S = plen + max_new
                kv = [tuple(torch.zeros((len(rows), S, w),
                                        device=self.device)
                            for w in (c["kv_lora_rank"],
                                      c["qk_rope_head_dim"]))
                      for _ in self.ref.layers]
                per = max(1, MAX_TOKENS_PER_PASS // plen)
                for a in range(0, len(rows), per):
                    part = rows[a:a + per]
                    toks = torch.as_tensor(
                        np.stack([requests[i].prompt for i in part]),
                        dtype=torch.long, device=self.device)
                    view = [(ckv[a:a + per], kr[a:a + per])
                            for ckv, kr in kv]
                    first[part] = self._last_logits(toks, view, 0) \
                        .argmax(-1, keepdim=True)
                groups.append((rows, plen, kv))
        return Handoff(requests, first, max(by_len), max_new, groups)

    def decode(self, handoff) -> list:
        import torch
        from perfbench.reference.engine import Answer
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
