"""The control, and the readings that a cell's limits are set from.

The control is the plain reference put in the program's place and
computed one precision below the bf16 the configuration states: every
projection's operands in fp8 (``ReferenceEngine``). It serves the cell's
traffic through the harness's own loop and comparison, greedy, through a
K/V cache of its own, and has to read as not correct there.

  python3 -m perfbench.control --workload <cell> --seeds 1,2,3 \\
      [--fault state_unchanged] [--no-control]

reads, on each seed, one batch at the cell's own load through the
program (or, with ``--fault``, one of ``perfbench/faults.py``'s broken
engines in its place): the numbers the benchmark compares over the
cell's sample (``program_gap``, ``program_mean``) and, unless
``--no-control``, the control's at the same positions (the reference's
gap of the token fp8 puts first there: ``control_gap``,
``control_mean``). The engine is built once and every seed's weights are
drawn into it again, so a dozen seeds cost one set-up.

  python3 -m perfbench.control --workload <cell> --seeds 1,2 --run \\
      {control,<fault>} [--seconds 51]

runs the whole of ``perfbench.run``'s run (window, then comparison) with
that engine in the program's place, one result line per seed.

Both on the card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys

from perfbench import faults, run

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


def factory(c: dict, quant: str | None = "fp8"):
    """(cfg, offload, device) -> the control engine for configuration
    file ``c``, as ``run.run_cell`` takes an engine factory."""
    return lambda cfg, offload, device: ReferenceEngine(c, device, quant)


def readings(cell: run.Cell, seeds: list[int], device="cuda",
             engine_factory=None, control: bool = True) -> list[dict]:
    import torch
    from repro_torch.launch.serve import ServeEngine
    from perfbench.reference.check import (control_gaps, mean, sample,
                                           served_gaps, widest)
    from perfbench.reference.model import Reference
    from perfbench.reference.weights import draw_all
    from perfbench.traffic import Traffic
    c = cell.config
    cfg = run.port_config(c)
    offload = bool(c.get("serve", {}).get("offload_weights", False))
    factory_ = engine_factory or (lambda cfg, off, dev: ServeEngine(
        cfg, offload_weights=off, rng_seed=0, device=dev))
    engine = factory_(cfg, offload, device)
    out = []
    for seed in seeds:
        run.fill_weights(engine.params_home, c, seed, device)
        traffic = Traffic(cell.mix, c["vocab_size"], seed)
        batch = run.serve_batch(engine, traffic.next_batch())
        picked = sample(list(zip(batch["draws"], batch["served"])), seed,
                        cell.settings["sample_tokens"])
        items = [(d.prompt, s) for d, s in picked]
        w = draw_all(c, seed, device)
        ref = Reference(c, w)
        gaps = served_gaps(ref, items)
        ctl = control_gaps(ref, Reference(c, w, quant="fp8"), items) \
            if control else None
        del w, ref
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        row = {"seed": seed, "tokens": sum(len(s) for _, s in items),
               "program_gap": widest(gaps), "program_mean": mean(gaps)}
        if ctl is not None:
            row.update(control_gap=widest(ctl), control_mean=mean(ctl))
        out.append(row)
        print(json.dumps(row), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--run", choices=["control", *sorted(faults.FAULTS)])
    ap.add_argument("--seconds", type=float, default=51)
    args = ap.parse_args(argv)
    run.cache_env()
    import torch
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.run:
        for seed in seeds:
            make = factory(cell.config) if args.run == "control" \
                else faults.factory(args.run)
            out = run.run_cell(cell, seed, args.seconds, False, "cuda",
                               engine_factory=make)
            print(json.dumps({"run": args.run, "seed": seed, **out}),
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
        return 0
    readings(cell, seeds,
             engine_factory=args.fault and faults.factory(args.fault),
             control=not args.no_control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
