"""Serving driver: batched request engine.

Requests with different prompt lengths are left-padded with token 0 into
one prefill batch, then decoded together, greedy (argmax), one token per
step, as the reference's ``ServeEngine`` does. Prefill attention goes
through the hand-written flash attention kernel by default
(``ParallelConfig(attention_kernel="kernel")``).

  python -m repro_torch.launch.serve --arch yi-9b --requests 4 \\
      --prompt 1024 --gen 32                      # full width, on cuda
  python -m repro_torch.launch.serve --arch yi-9b --reduced --device cpu

Unlike the reference's, ``--reduced`` is off by default: the command runs
the architecture at its full width. Weight offload and the simulated
``--paged-sim`` / ``--disagg-sim`` / ``--degrade-sim`` modes come with the
pager slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.config.base import ParallelConfig, get_config
from repro_torch.models.model import Model
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.runtime.fault import StragglerStats


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int
    max_new: int


@dataclasses.dataclass
class Result:
    rid: int
    tokens: list
    prefill_ms: float
    decode_ms_per_tok: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    def __init__(self, cfg,
                 parallel: ParallelConfig = ParallelConfig(
                     attention_kernel="kernel"),
                 offload_weights: bool = False, rng_seed: int = 0,
                 device=None, tracer=NULL_TRACER):
        """An engine for ``cfg`` on ``device`` (default ``cuda``; raises if
        there is none) with bf16 weights drawn from a generator seeded with
        ``rng_seed`` on that device.

        Observability as in the reference: wall-clock prefill/decode-step
        spans plus a ``StragglerStats`` fed one sample per decode step,
        whose summary lands in the metrics snapshot. The reference's
        ``slo`` monitor comes with the serve control plane.
        """
        if offload_weights:
            raise NotImplementedError(
                "weight offload to pinned host memory (the reference's "
                "core/offload.py) is not ported yet; it comes with the "
                "pager slice")
        self.cfg = cfg
        self.tracer = tracer
        self.straggler = StragglerStats()
        self.model = Model.create(cfg, parallel, device)
        gen = torch.Generator(device=self.model.device).manual_seed(rng_seed)
        self.model.init(gen, dtype=torch.bfloat16)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.inference_mode()
    def prefill(self, requests: list[Request]) -> "PrefillHandoff":
        """The prefill role: run the prompt pass and hand off everything
        the decode role needs (KV cache, first tokens, step offsets)."""
        B = len(requests)
        tracer = self.tracer
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
        if tracer.enabled:
            for r in requests:
                tracer.instant("serve.admit", track=("serving", "engine"),
                               cat="serve", rid=r.rid,
                               prompt_len=len(r.prompt), max_new=r.max_new)
        t0 = time.perf_counter()
        max_new = max(r.max_new for r in requests)
        with tracer.span("serve.prefill", track=("serving", "engine"),
                         cat="serve", batch=B, prompt_len=plen):
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            logits, cache = self.model.prefill(self.model.params, batch,
                                               plen + max_new)
            tok = torch.argmax(logits, dim=-1)
            _sync(self.device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        return PrefillHandoff(requests, cache, tok, plen, max_new,
                              prefill_ms)

    @torch.inference_mode()
    def decode(self, handoff: "PrefillHandoff") -> list[Result]:
        """The decode role: step the handed-off KV cache to completion
        (the cache is updated in place)."""
        requests = handoff.requests
        B = len(requests)
        tracer = self.tracer
        params = self.model.params
        cache, tok = handoff.cache, handoff.tok
        outs = [[] for _ in requests]
        t0 = time.perf_counter()
        for s in range(handoff.max_new):
            ts = time.perf_counter()
            with tracer.span("serve.decode_step",
                             track=("serving", "engine"), cat="serve",
                             step=s, batch=B):
                logits, cache = self.model.decode(params, cache, tok,
                                                  handoff.plen + s)
                tok = torch.argmax(logits, dim=-1)
                # one device read for the whole batch, not B scalar reads
                tok_host = tok.cpu().numpy()
            # per-step wall time feeds the straggler detector
            self.straggler.record(time.perf_counter() - ts)
            for i in range(B):
                outs[i].append(int(tok_host[i, 0]))
        ms_per_tok = (time.perf_counter() - t0) * 1e3 / handoff.max_new
        if tracer.enabled:
            m = tracer.metrics
            m.add("serve.requests", B)
            m.add("serve.decode_steps", handoff.max_new)
            m.add("serve.tokens_generated", B * handoff.max_new)
            m.set("serve.prefill_ms", handoff.prefill_ms)
            m.set("serve.decode_ms_per_tok", ms_per_tok)
            for k, v in self.straggler.summary().items():
                m.set(f"serve.straggler.{k}", v)
        return [Result(r.rid, outs[i][:r.max_new], handoff.prefill_ms,
                       ms_per_tok)
                for i, r in enumerate(requests)]

    def serve(self, requests: list[Request]) -> list[Result]:
        """Monolithic serving: prefill role then decode role, in-process."""
        return self.decode(self.prefill(requests))


@dataclasses.dataclass
class PrefillHandoff:
    """What the prefill role produces and the decode role consumes."""
    requests: list               # the Requests this batch covers
    cache: dict                  # model KV cache (decode updates it in place)
    tok: torch.Tensor            # (B, 1) first sampled tokens
    plen: int                    # padded prompt length (step offset base)
    max_new: int
    prefill_ms: float


def make_requests(cfg, n: int, prompt: int, gen: int,
                  seed: int = 0) -> list[Request]:
    """``n`` requests of ``prompt - (i % 4)`` random tokens, ``gen`` new
    tokens each, as the reference's CLI builds them."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    prompt - (i % 4)).astype(np.int32), gen)
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--reduced", action="store_true",
                    help="a tiny config of the same family (default: full "
                         "width)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS.json",
                    help="write the metrics snapshot "
                         "(MetricsRegistry.to_json) here")
    args = ap.parse_args(argv)

    tracer = Tracer() if args.metrics_out else NULL_TRACER
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    engine = ServeEngine(cfg, device=args.device, tracer=tracer)
    reqs = make_requests(cfg, args.requests, args.prompt, args.gen)
    results = engine.serve(reqs)
    tps = args.requests * args.gen / (results[0].decode_ms_per_tok
                                      * args.gen / 1e3)
    dev = engine.device
    print(json.dumps({
        "requests": len(results),
        "prefill_ms": results[0].prefill_ms,
        "decode_ms_per_tok": results[0].decode_ms_per_tok,
        "tokens_per_s": tps,
        "offloaded": False,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "sample": results[0].tokens[:8],
    }))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(tracer.metrics.to_json(), f, indent=2, sort_keys=True)


if __name__ == "__main__":
    main()
