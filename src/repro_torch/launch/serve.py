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
the architecture at its full width.

With the weights resident on a CUDA device, the decode role captures a
batch shape's decode step once as a CUDA graph and replays it every step
(``DecodeGraph``; where ``decode_graph_engages``), so the host launches
one graph, not the step's few thousand kernels.

``--offload-weights`` keeps the weights in pinned host memory and fetches
the whole tree to the device on every prefill and decode call, the
paper's synchronous offload mode (§6.1.5), whose step time the host link
sets; its decode runs eagerly. ``--trace-out``, ``--recorder-out``,
``--openmetrics-out`` and ``--metrics-listen`` write or serve what the
run observed:

  python -m repro_torch.launch.serve --reduced --device cpu \
      --offload-weights --trace-out t.json

``DecodeScheduler`` is the deadline-aware decode loop over a tier-split
``PagedKVCache``: it plans host->HBM page prefetches through the fabric
simulator and admits each sequence into the decode batch at the first step
deadline by which *its* pages have landed (``PrefetchPlan.ready_by``).
``--paged-sim`` reports the fp16-vs-int8 comparison on one page set; the
two pagers' pools live on the device, the schedule is a simulation on the
``--system`` preset (never a measurement of the card):

  python -m repro_torch.launch.serve --paged-sim --system gh200

``--disagg-sim`` simulates disaggregated prefill/decode (KV pages shipped
between compute nodes, ``--kv-dtype int8`` for the compressed ship) and
``--degrade-sim`` the degradation loop (the host link cut to
``--degrade-factor`` at ``--degrade-round``; the reacting run beside the
no-reaction baseline). Their pagers live on ``--device``; their times are
simulated on the ``--system`` preset:

  python -m repro_torch.launch.serve --disagg-sim --kv-dtype int8 \
      --device cpu
  python -m repro_torch.launch.serve --degrade-sim --device cpu

``--calibration-profile p.json`` (a ``CalibrationProfile``, such as one
``CalibrationRunner(source="torch")`` fitted from copies timed on the card)
makes the three simulated modes plan on the fitted link constants;
``--recalibrate`` closes the drift loop in ``--degrade-sim``:

  python -m repro_torch.launch.serve --paged-sim \
      --calibration-profile p.json --device cpu
  python -m repro_torch.launch.serve --degrade-sim \
      --calibration-profile p.json --recalibrate --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.config.base import ParallelConfig, get_config
from repro_torch.core.offload import OffloadStats, fetch_to_device, put_tree
from repro_torch.models import moe
from repro_torch.models.context import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.params import tree_flatten, tree_map
from repro_torch.models.transformer import segment_plan
from repro_torch.obs import (NULL_TRACER, BandwidthLedger, FlightRecorder,
                             Tracer, openmetrics_text, serve_openmetrics,
                             write_chrome_trace, write_openmetrics)
from repro_torch.runtime.fault import StragglerStats


ENGINE_TRACK = ("serving", "engine")


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


def decode_graph_engages(cfg, device, offload_weights: bool,
                         mesh=None) -> bool:
    """Whether the decode role replays a captured CUDA graph: on a CUDA
    device, with the weights resident (an offloaded engine fetches a tree
    at new addresses every call), off a mesh, and where every segment is
    GQA attention blocks (dense or MoE, windowed or not, M-RoPE included),
    the blocks a gpu test holds replayed against their eager step. MLA
    reads its position on the device too, but no gpu test holds a replayed
    MLA step yet; MLA, Mamba2, xLSTM and whisper decode eagerly."""
    if (torch.device(device).type != "cuda" or offload_weights
            or mesh is not None or cfg.encoder_decoder
            or cfg.attn_type == "mla"):
        return False
    return all(seg.kind in ("attn", "gemma") for seg in segment_plan(cfg))


def graph_key(cache: dict, tok: torch.Tensor) -> tuple:
    """(batch, cache length): the shape a decode graph is captured at (the
    K/V leaves are (..., B, S or window, Hkv, dh))."""
    return tok.shape[0], max(leaf.shape[-3] for _, leaf in tree_flatten(cache))


class DecodeGraph:
    """One decode step at one ``graph_key``, captured as a CUDA graph, and
    the static buffers it reads and writes: the input token (B, 1), the
    position (1,), a cache tree at the decode shapes (the engine's copy,
    not the handoff's) and the step's logits. The graph holds the argmax
    and its write over the input token, and advances the position, so a
    replay leaves the next step's input in place. ``step`` (the model's
    decode as it stands at capture) and ``params`` (the resident weights)
    are baked in: ``serves`` tells whether they are still the engine's."""

    WARMUP = 3          # eager steps on a side stream before the capture

    def __init__(self, step, params: dict, cache: dict, tok: torch.Tensor,
                 pos: int):
        self.key = graph_key(cache, tok)
        self.step = step
        self.weights = [leaf for _, leaf in tree_flatten(params)]
        self.cache = tree_map(torch.empty_like, cache)
        self.tok = torch.empty_like(tok)
        self.pos = torch.empty(1, dtype=torch.int64, device=tok.device)
        self.load(cache, tok, pos)

        def body():
            logits, _ = step(params, self.cache, self.tok, self.pos)
            self.tok.copy_(torch.argmax(logits, dim=-1))
            self.pos.add_(1)
            return logits

        here = torch.cuda.current_stream(tok.device)
        side = torch.cuda.Stream(tok.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):   # at ``pos``: inside the cache
                self.pos.fill_(pos)
                body()
        here.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = body()

    def serves(self, step, params: dict, cache: dict,
               tok: torch.Tensor) -> bool:
        leaves = [leaf for _, leaf in tree_flatten(params)]
        return (self.key == graph_key(cache, tok) and self.step == step
                and len(leaves) == len(self.weights)
                and all(a is b for a, b in zip(leaves, self.weights)))

    def load(self, cache: dict, tok: torch.Tensor, pos: int) -> None:
        """A batch's handoff into the static buffers (device copies)."""
        tree_map(lambda mine, theirs: mine.copy_(theirs), self.cache, cache)
        self.tok.copy_(tok)
        self.pos.fill_(pos)

    def replay(self) -> torch.Tensor:
        """One step; returns the next token, the static input buffer that
        the next replay overwrites."""
        self.graph.replay()
        return self.tok


class ServeEngine:
    def __init__(self, cfg,
                 parallel: ParallelConfig = ParallelConfig(
                     attention_kernel="kernel"),
                 offload_weights: bool = False, rng_seed: int = 0,
                 device=None, tracer=NULL_TRACER, slo=None):
        """An engine for ``cfg`` on ``device`` (default ``cuda``; raises if
        there is none) with bf16 weights drawn from a generator seeded with
        ``rng_seed`` on that device.

        With ``offload_weights`` the drawn weights move to the host tier
        (pinned memory on a CUDA device; raises if pinning fails) and the
        device copy is freed; every prefill and decode call then fetches
        the whole tree to the device and drops it after use.

        Observability: the reference's wall-clock ``serve.prefill`` and
        ``serve.decode_step`` spans, each split by spans nested in it:
        ``offload.fetch`` (offloaded only; ``bytes``, the tree's),
        ``model.prefill`` / ``model.decode`` (the host issuing the model's
        work and the argmax) and ``serve.readback`` (the host waiting for
        the device). Every span of a batch carries its ``batch_id``. While
        the tracer is on, a ``StragglerStats`` is fed one sample per decode
        step, and its summary lands in the metrics snapshot. Where the
        decode role replays a graph (``decode_graph_engages``),
        ``model.decode`` carries ``graph=1`` (else 0), a capture is a
        ``serve.graph_capture`` span (``B``, ``cache_len``), and the
        snapshot counts ``serve.decode_graph.captures`` and
        ``serve.decode_graph.replays``. With MoE layers (dropless in
        both roles), each ``model.prefill`` / ``model.decode`` span carries
        ``moe`` = {``routed_pairs``, ``dropped_pairs``,
        ``expert_load_max``}, read back after the role's own sync, and the
        snapshot counts ``moe.routed_pairs`` and ``moe.dropped_pairs`` and
        keeps the largest ``moe.expert_load_max`` (the busiest expert's
        share of a layer's pairs). ``slo``
        optionally attaches an ``obs.SLOMonitor``: one latency observation
        per finished request (class "serve").

        The engine serves token prompts, so an encoder-decoder config
        (whisper) is refused here: its prefill takes frames, which no
        request carries (the reference's engine fails later, with a
        ``KeyError`` on ``frames``). Whisper runs through ``Model.prefill``
        of ``{"frames": ...}`` and ``Model.decode``.
        """
        if cfg.encoder_decoder:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder model: ServeEngine "
                f"serves token prompts and its prefill needs frames; run "
                f"it through Model.prefill({{'frames': ...}}) and "
                f"Model.decode")
        self.cfg = cfg
        self.tracer = tracer
        self.slo = slo
        self.straggler = StragglerStats()
        self.model = Model.create(cfg, parallel, device)
        gen = torch.Generator(device=self.model.device).manual_seed(rng_seed)
        self.model.init(gen, dtype=torch.bfloat16)
        self.offload = offload_weights
        self.batches = 0             # batch ids handed out by prefill
        if offload_weights:
            self.model.set_params(put_tree(self.model.params, "pinned_host",
                                           self.device))
            stats = OffloadStats()
            stats.record(self.params_home, "to_device")
            self.fetch_bytes = stats.bytes_to_device
        self.graphs = decode_graph_engages(cfg, self.device, offload_weights,
                                           self.model.mctx.mesh)
        self._graph: Optional[DecodeGraph] = None
        # what the dropless MoE layers count, on the device (a captured
        # decode step counts too); read only while a tracer is on
        self.moe_stats = None
        if cfg.moe is not None:
            self.moe_stats = self.model.mctx.stats = {}

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def params_home(self) -> dict:
        """The weights where they live between calls: on the device, or
        in the host tier when offloaded."""
        return self.model.params

    def _params(self, batch_id: int) -> dict:
        """Paper-faithful sync fetch when offloaded (copy-on-demand)."""
        if self.offload:
            with self.tracer.span("offload.fetch", track=ENGINE_TRACK,
                                  cat="serve", batch_id=batch_id,
                                  bytes=self.fetch_bytes):
                return fetch_to_device(self.params_home, self.device)
        return self.params_home

    def _moe_args(self) -> dict:
        """``{"moe": {}}`` for a model span where the tracer is on and the
        model has MoE layers: the counters are zeroed for the call, and
        ``_read_moe`` fills the dict after the role's sync. Else ``{}``."""
        if self.moe_stats is None or not self.tracer.enabled:
            return {}
        moe.zero_counts(self.moe_stats)
        return {"moe": {}}

    def _read_moe(self, args: dict, tokens: int) -> None:
        """The call's MoE counters (``tokens`` routed through each MoE
        layer), after the device sync, into ``args["moe"]`` and the
        snapshot: ``moe.routed_pairs`` and ``moe.dropped_pairs`` add up,
        ``moe.expert_load_max`` (the busiest expert's share of a layer's
        pairs) keeps the largest seen."""
        if "moe" not in args:
            return
        c = moe.read_counts(self.moe_stats)
        share = c["busiest_pairs"] / (tokens * self.cfg.moe.top_k)
        args["moe"].update(routed_pairs=c["routed_pairs"],
                           dropped_pairs=c["dropped_pairs"],
                           expert_load_max=share)
        m = self.tracer.metrics
        m.add("moe.routed_pairs", c["routed_pairs"])
        m.add("moe.dropped_pairs", c["dropped_pairs"])
        m.set("moe.expert_load_max",
              max(share, m.gauge("moe.expert_load_max", 0.0)))

    def _decode_graph(self, handoff: "PrefillHandoff") -> DecodeGraph:
        """The graph for this batch, loaded with its handoff. It is
        captured on first use; a new key, new weights or a new decode
        callable drop the old graph and its buffers before capturing
        again, so at most one is held."""
        step, params = self.model.decode, self.params_home
        cache, tok, pos = handoff.cache, handoff.tok, handoff.plen
        g = self._graph
        if g is None or not g.serves(step, params, cache, tok):
            self._graph = g = None
            B, S = graph_key(cache, tok)
            with self.tracer.span("serve.graph_capture", track=ENGINE_TRACK,
                                  cat="serve", batch_id=handoff.batch_id,
                                  B=B, cache_len=S):
                g = self._graph = DecodeGraph(step, params, cache, tok, pos)
            if self.tracer.enabled:
                self.tracer.metrics.add("serve.decode_graph.captures", 1)
        g.load(cache, tok, pos)      # the capture's warm-up stepped the copy
        return g

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
                tracer.instant("serve.admit", track=ENGINE_TRACK,
                               cat="serve", rid=r.rid,
                               prompt_len=len(r.prompt), max_new=r.max_new)
        self.batches += 1
        bid = self.batches
        t0 = time.perf_counter()
        max_new = max(r.max_new for r in requests)
        with tracer.span("serve.prefill", track=ENGINE_TRACK, cat="serve",
                         batch=B, prompt_len=plen, batch_id=bid):
            params = self._params(bid)
            moe_args = self._moe_args()
            with tracer.span("model.prefill", track=ENGINE_TRACK,
                             cat="serve", batch_id=bid, **moe_args):
                batch = {"tokens": torch.from_numpy(toks).to(self.device)}
                logits, cache = self.model.prefill(params, batch,
                                                   plen + max_new)
                del params       # a fetched tree lives for one call only
                tok = torch.argmax(logits, dim=-1)
            with tracer.span("serve.readback", track=ENGINE_TRACK,
                             cat="serve", batch_id=bid):
                _sync(self.device)
            self._read_moe(moe_args, B * plen)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        return PrefillHandoff(requests, cache, tok, plen, max_new,
                              prefill_ms, bid)

    @torch.inference_mode()
    def decode(self, handoff: "PrefillHandoff") -> list[Result]:
        """The decode role: step the handed-off KV cache to completion.
        Eagerly the handoff's cache is updated in place; a graph replay
        steps the engine's copy of it and leaves the handoff as it was."""
        requests = handoff.requests
        B = len(requests)
        tracer = self.tracer
        cache, tok, bid = handoff.cache, handoff.tok, handoff.batch_id
        outs = [[] for _ in requests]
        traced = tracer.enabled
        t0 = time.perf_counter()
        graph = self._decode_graph(handoff) if self.graphs else None
        for s in range(handoff.max_new):
            ts = time.perf_counter()
            with tracer.span("serve.decode_step", track=ENGINE_TRACK,
                             cat="serve", step=s, batch=B, batch_id=bid):
                params = self._params(bid) if graph is None else None
                moe_args = self._moe_args()
                with tracer.span("model.decode", track=ENGINE_TRACK,
                                 cat="serve", batch_id=bid, step=s,
                                 graph=int(graph is not None), **moe_args):
                    if graph is not None:
                        tok = graph.replay()
                    else:
                        logits, cache = self.model.decode(
                            params, cache, tok, handoff.plen + s)
                        del params   # dropped before the next step's fetch
                        tok = torch.argmax(logits, dim=-1)
                with tracer.span("serve.readback", track=ENGINE_TRACK,
                                 cat="serve", batch_id=bid):
                    # one device read for the whole batch, not B scalar reads
                    tok_host = tok.cpu().numpy()
                self._read_moe(moe_args, B)
            if traced:
                # per-step wall time feeds the straggler detector, whose
                # summary only the traced metrics snapshot reads
                self.straggler.record(time.perf_counter() - ts)
            for i in range(B):
                outs[i].append(int(tok_host[i, 0]))
        ms_per_tok = (time.perf_counter() - t0) * 1e3 / handoff.max_new
        if traced:
            m = tracer.metrics
            m.add("serve.requests", B)
            m.add("serve.decode_steps", handoff.max_new)
            m.add("serve.tokens_generated", B * handoff.max_new)
            if graph is not None:
                m.add("serve.decode_graph.replays", handoff.max_new)
            m.set("serve.prefill_ms", handoff.prefill_ms)
            m.set("serve.decode_ms_per_tok", ms_per_tok)
            for k, v in self.straggler.summary().items():
                m.set(f"serve.straggler.{k}", v)
        if self.slo is not None:
            lat = (handoff.prefill_ms + ms_per_tok * handoff.max_new) * 1e-3
            for r in requests:
                self.slo.observe("serve", lat)
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
    cache: dict                  # model KV cache: an eager decode steps it in
    #                              place, a graph decode steps a copy
    tok: torch.Tensor            # (B, 1) first sampled tokens
    plen: int                    # padded prompt length (step offset base)
    max_new: int
    prefill_ms: float
    batch_id: int = 0            # the engine's id for this batch's spans


def make_requests(cfg, n: int, prompt: int, gen: int,
                  seed: int = 0) -> list[Request]:
    """``n`` requests of ``prompt - (i % 4)`` random tokens, ``gen`` new
    tokens each, as the reference's CLI builds them."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size,
                                    prompt - (i % 4)).astype(np.int32), gen)
            for i in range(n)]


# --------------------------------------------------------------------------
# Deadline-aware decode scheduling over the paged, tiered KV cache
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodeStep:
    """One fired decode step of the scheduled loop."""
    step: int
    deadline: float              # when the step fires (s, sim time)
    seq_ids: tuple               # sequences decoded in this step's batch
    pages_resident: int          # host pages landed by the deadline


@dataclasses.dataclass(frozen=True)
class DecodeSchedule:
    """A simulated decode run: per-step batches + completion accounting."""
    steps: tuple                 # DecodeStep in firing order
    admit_time: dict             # seq id -> sim time it joined the batch
    finish_time: dict            # seq id -> sim time its last step is done
    makespan: float              # when the last sequence finishes (s)
    sync_makespan: float         # baseline: stall until ALL pages landed
    prefetch_total: float        # PrefetchPlan.total_time
    step_time: float
    violations: dict = dataclasses.field(default_factory=dict)
    # seq id -> overrun (s) past its deadline; only sequences given a
    # deadline via ``schedule(..., deadlines=)`` can appear here
    plan: object = None
    # the prefetch/transfer plan the schedule admitted against — the
    # drift sentinel replays it against calibration predictions

    @property
    def mean_completion(self) -> float:
        vals = list(self.finish_time.values())
        return sum(vals) / len(vals) if vals else 0.0

    @property
    def speedup(self) -> float:
        """Mean-latency win of deadline-aware admission: in the sync
        baseline every sequence waits for the WHOLE page set, so its mean
        completion equals the sync makespan; here each sequence finishes
        n_steps after its own pages landed."""
        return self.sync_makespan / max(self.mean_completion, 1e-18)


class DecodeScheduler:
    """Fires decode steps as prefetched pages land (PrefetchPlan.ready_by).

    The paper-faithful loop stalls every decode step until the whole page
    set is resident; this scheduler admits each sequence into the continuous
    batch at the first step deadline by which *its* host-tier pages have
    arrived, so sequences whose pages live in HBM (or landed early) decode
    while the slow-tier fetches are still in flight. With the pager's int8
    cold tier (``PagerConfig(kv_dtype="int8")``) every ETA is ~2x sooner —
    the bandwidth win turns directly into earlier admission. Page fetches
    ride the pager's DMA QoS class (high priority by default, overridable
    via ``priority``): under a bulk background stream the
    prioritized ETAs — and with them every admission deadline — tighten
    toward the uncontended schedule.
    """

    def __init__(self, cache, *, system=None, background: tuple = (),
                 step_time: float = 500e-6, priority=None,
                 tracer=NULL_TRACER):
        self.cache = cache
        self.system = system
        self.background = background
        self.step_time = float(step_time)
        self.priority = priority      # None -> pager's configured QoS class
        # Observability: admission instants (with deadline slack), one
        # async request span admit->finish per sequence, and a B/E span
        # per fired decode step — all in sim time, so the exported trace
        # lines up with the fabric's per-link utilization tracks.
        self.tracer = tracer

    def ready_times(self, seq_ids: list, plan) -> dict:
        """Sim time each sequence's host pages are fully resident."""
        out = {}
        for s in seq_ids:
            pages = [p for p in self.cache.tables[s]
                     if self.cache.tier_of_page[p] == 1]
            out[s] = max((plan.eta[p] for p in pages), default=0.0)
        return out

    def schedule(self, seq_ids: list, n_steps: int,
                 deadlines: Optional[dict] = None) -> DecodeSchedule:
        """Simulate ``n_steps`` decode steps per sequence, admitting each
        sequence at its pages' arrival (deadline-aware continuous batch).

        ``deadlines`` optionally maps seq id -> SLO completion deadline
        (s, sim time). A sequence finishing after its deadline lands in
        ``DecodeSchedule.violations`` with its overrun — the interactive-
        class protection signal the degradation loop (and its no-reaction
        baseline) are judged on.
        """
        plan = self.cache.plan_prefetch(seq_ids, system=self.system,
                                        background=self.background,
                                        priority=self.priority)
        ready = self.ready_times(seq_ids, plan)
        seq_flows = None
        if self.tracer.enabled:
            # flow ids the pager's plan_transfers assigned ("page{p}") —
            # the per-request attribution joins these against the fabric
            # sim's flow lifecycle events
            seq_flows = {s: [f"page{p}" for p in self.cache.tables[s]
                             if self.cache.tier_of_page[p] == 1]
                         for s in seq_ids}
        return admission_schedule(ready, plan, n_steps, self.step_time,
                                  deadlines=deadlines,
                                  seq_flows=seq_flows, tracer=self.tracer)


def admission_schedule(ready: dict, plan, n_steps: int, step_time: float,
                       *, deadlines: Optional[dict] = None,
                       seq_flows: Optional[dict] = None,
                       starts: Optional[dict] = None,
                       prefill_done: Optional[dict] = None,
                       tracer=NULL_TRACER) -> DecodeSchedule:
    """The deadline-aware admission loop itself, plan-agnostic.

    ``ready`` maps seq id -> sim time its pages are fully resident (dict
    order is the admission preference order); ``plan`` is anything with
    ``ready_by(t)`` and ``total_time`` — a pager ``PrefetchPlan`` or a
    transport ``TransferPlan`` (the disaggregated prefill->decode shipment
    reuses this loop unchanged: pages landing over the cross-host route
    admit sequences exactly like host->HBM prefetches do).

    ``seq_flows`` (seq id -> list of fabric flow ids carrying its bytes)
    turns on per-request attribution: one ``attrib.request`` instant per
    sequence ties the request to its flows, its pages-ready time, its
    start (``starts``, default 0.0 — sim-time origin) and optionally its
    prefill completion (``prefill_done``), which is everything
    ``repro_torch.obs.attribution`` needs to rebuild the critical path.
    """
    seq_ids = list(ready)
    if tracer.enabled and seq_flows is not None:
        for s in seq_ids:
            t0 = (starts or {}).get(s, 0.0)
            extra = {}
            pd = (prefill_done or {}).get(s)
            if pd is not None:
                extra["prefill_done"] = pd
            tracer.instant("attrib.request", ts=t0,
                           track=("scheduler", "attribution"),
                           cat="attrib", rid=s, start=t0, ready=ready[s],
                           flows=list(seq_flows.get(s, ())), **extra)
    remaining = {s: n_steps for s in seq_ids}
    admit: dict = {}
    finish: dict = {}
    steps = []
    t = min(ready.values()) if ready else 0.0
    k = 0
    traced = tracer.enabled
    while any(r > 0 for r in remaining.values()):
        resident = set(plan.ready_by(t))
        active = tuple(s for s in seq_ids
                       if remaining[s] > 0 and ready[s] <= t)
        if not active:                  # idle until the next arrival
            t = min(ready[s] for s in seq_ids if remaining[s] > 0)
            continue
        for s in active:
            if s not in admit:
                admit[s] = t
                if traced:
                    # slack: how long the sequence sat decode-ready
                    # (pages landed at ready[s]) before the step grid
                    # admitted it — deadline-alignment cost, not fabric
                    tracer.instant(
                        "sched.admit", ts=t,
                        track=("scheduler", "admissions"), cat="sched",
                        seq=s, ready=ready[s],
                        deadline_slack=t - ready[s])
                    tracer.async_begin(
                        f"seq{s}", id=f"seq{s}", ts=t,
                        track=("scheduler", "requests"), cat="sched",
                        seq=s, n_steps=n_steps)
            remaining[s] -= 1
            if remaining[s] == 0:
                finish[s] = t + step_time
                if traced:
                    tracer.async_end(
                        f"seq{s}", id=f"seq{s}", ts=finish[s],
                        track=("scheduler", "requests"), cat="sched",
                        completion=finish[s])
        steps.append(DecodeStep(k, t, active, len(resident)))
        if traced:
            tracer.begin("sched.step", ts=t,
                         track=("scheduler", "steps"), cat="sched",
                         step=k, batch=len(active),
                         pages_resident=len(resident))
            tracer.end("sched.step", ts=t + step_time,
                       track=("scheduler", "steps"), cat="sched")
        k += 1
        t += step_time
    makespan = max(finish.values()) if finish else 0.0
    sync = plan.total_time + n_steps * step_time
    violations = {}
    if deadlines:
        for s, dl in deadlines.items():
            done = finish.get(s)
            if done is not None and done > dl:
                violations[s] = done - dl
    sched = DecodeSchedule(tuple(steps), admit, finish, makespan, sync,
                           plan.total_time, step_time, violations,
                           plan=plan)
    if traced:
        m = tracer.metrics
        m.add("sched.steps", len(steps))
        m.add("sched.sequences", len(seq_ids))
        m.set("sched.makespan_s", makespan)
        m.set("sched.mean_completion_s", sched.mean_completion)
        m.set("sched.prefetch_total_s", plan.total_time)
        if deadlines:
            m.add("sched.deadline_violations", len(violations))
            for s, over in violations.items():
                tracer.instant("sched.deadline_miss",
                               ts=finish[s],
                               track=("scheduler", "admissions"),
                               cat="sched", seq=s, overrun_s=over)
    return sched


def paired_kv_caches(*, requests: int = 8, tokens: int = 1056,
                     page_size: int = 64, kv_heads: int = 8,
                     head_dim: int = 128, weights: tuple = (2, 1),
                     device=None) -> dict:
    """{'fp16': pager, 'int8': pager} with identical placement and fill —
    the 'same page set' premise every fp-vs-int8 ratio rests on lives in
    exactly one place (the kv_quant benchmark family reuses this). The
    pools live on ``device`` (default ``cuda``; raises if there is none)."""
    from repro_torch.serving.pager import PagedKVCache, PagerConfig
    device = resolve_device(device)
    n_pages = max(64, requests * (-(-tokens // page_size)) + 8)
    kv = torch.zeros((tokens, kv_heads, head_dim), dtype=torch.bfloat16,
                     device=device)
    caches = {}
    for label, kv_dtype in (("fp16", None), ("int8", "int8")):
        c = PagedKVCache(PagerConfig(
            page_size=page_size, n_pages=n_pages, kv_heads=kv_heads,
            head_dim=head_dim, weights=weights, dtype="bfloat16",
            kv_dtype=kv_dtype), device=device)
        for s in range(requests):
            c.allocate(s)
            c.append(s, kv, kv)
        caches[label] = c
    return caches


def simulate_paged_decode(*, requests: int = 8, prompt: int = 1024,
                          gen: int = 32, page_size: int = 64,
                          kv_heads: int = 8, head_dim: int = 128,
                          weights: tuple = (2, 1), system_name: str =
                          "tpu_v5e", step_us: float = 100.0,
                          prefetch_priority: int = 0,
                          calibration_profile=None,
                          tracer=NULL_TRACER, device=None) -> dict:
    """fp16-vs-int8 decode scheduling comparison on one page set.

    Builds two pagers with identical page placement — one bf16, one with
    the int8 cold tier — fills them with the same sequences, and schedules
    the same decode run against the same background traffic. The report is
    the headline benchmark: bytes over the host link, simulated contended
    prefetch completion, and decode makespan.

    ``prefetch_priority`` defaults to 0 (egalitarian): this report's
    premise is the *contended* regime the kv_quant family measures; raise
    it to see the DMA-QoS regime (the qos family's territory).

    ``calibration_profile`` (a ``repro_torch.calibrate.CalibrationProfile``
    or a path to its JSON artifact) swaps the nominal preset for the
    calibrated machine — every ETA and admission deadline then rests on
    *fitted* link constants instead of datasheet numbers. The two pagers'
    pools live on ``device`` (default ``cuda``; raises if there is none);
    the schedule itself is a simulation on the (calibrated) preset, not a
    measurement of the device.

    An enabled ``tracer`` records both runs into one trace, each scoped by
    label — the fp16 run's fabric tracks live under process
    ``"fp16/fabric"``, the int8 run's under ``"int8/fabric"`` — so the two
    contended prefetches can be compared side by side in Perfetto; the
    metrics snapshot is embedded in the report under ``"metrics"``.
    """
    from repro_torch.fabric.contention import Flow
    from repro_torch.fabric.systems import from_profile, get_system

    if calibration_profile is not None:
        from repro_torch.calibrate.profile import load_profile
        system = from_profile(load_profile(calibration_profile),
                              preset=system_name)
    else:
        system = get_system(system_name)
    # fixed-size background stream: both the fp16 and int8 runs must see
    # IDENTICAL contention (an open-ended flow would be auto-sized from
    # each cache's own page bytes, quietly shrinking the int8 background)
    bg = (Flow("offload", "host", "hbm", nbytes=256 << 20),)
    toks = prompt + gen
    out = {"system": system_name, "requests": requests,
           "tokens_per_seq": toks, "step_us": step_us,
           "background": True,
           "calibrated": calibration_profile is not None}
    caches = paired_kv_caches(requests=requests, tokens=toks,
                              page_size=page_size, kv_heads=kv_heads,
                              head_dim=head_dim, weights=weights,
                              device=device)
    for label, cache in caches.items():
        seqs = list(range(requests))
        sub = tracer.scoped(label, run=label)
        cache.tracer = sub            # pager spans + fabric sim timelines
        sched = DecodeScheduler(cache, system=system, background=bg,
                                step_time=step_us * 1e-6,
                                priority=prefetch_priority, tracer=sub)
        ds = sched.schedule(seqs, gen)
        n_host = len(cache.host_pages(seqs))
        out[label] = {
            "host_pages": n_host,
            "page_bytes": cache.host_page_bytes,
            "host_link_bytes": n_host * cache.host_page_bytes,
            "prefetch_total_s": ds.prefetch_total,
            "mean_completion_s": ds.mean_completion,
            "decode_makespan_s": ds.makespan,
            "sync_makespan_s": ds.sync_makespan,
            "overlap_speedup": round(ds.speedup, 3),
            "first_admit_s": min(ds.admit_time.values(), default=0.0),
        }
    fp, q = out["fp16"], out["int8"]
    out["bytes_reduction"] = round(
        fp["host_link_bytes"] / max(q["host_link_bytes"], 1), 3)
    out["prefetch_speedup"] = round(
        fp["prefetch_total_s"] / max(q["prefetch_total_s"], 1e-18), 3)
    out["decode_latency_speedup"] = round(
        fp["mean_completion_s"] / max(q["mean_completion_s"], 1e-18), 3)
    if tracer.enabled:
        out["metrics"] = tracer.metrics.to_json()
    return out


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
    ap.add_argument("--offload-weights", action="store_true",
                    help="keep the weights in pinned host memory and fetch "
                         "the whole tree to the device on every call")
    ap.add_argument("--paged-sim", action="store_true",
                    help="simulated fp16-vs-int8 paged decode scheduling "
                         "report (no model run)")
    ap.add_argument("--disagg-sim", action="store_true",
                    help="simulated disaggregated prefill/decode serve: "
                         "roles on separate compute nodes, KV pages "
                         "shipped over the contended fabric route the "
                         "cost model picks (no model run)")
    ap.add_argument("--kv-dtype", default=None, choices=["int8"],
                    help="ship pages in the pager's quantized cold-tier "
                         "layout (--disagg-sim)")
    ap.add_argument("--degrade-sim", action="store_true",
                    help="inject the headline degradation (host link "
                         "halved mid-serve) and report the reacting run "
                         "vs the no-reaction baseline (no model run)")
    ap.add_argument("--degrade-factor", type=float, default=0.5,
                    help="surviving bandwidth fraction for --degrade-sim")
    ap.add_argument("--degrade-round", type=int, default=4,
                    help="serve round the fault fires at (--degrade-sim)")
    ap.add_argument("--system", default="tpu_v5e",
                    help="fabric preset the simulated modes run on")
    ap.add_argument("--step-us", type=float, default=100.0,
                    help="decode step time of the simulated modes")
    ap.add_argument("--calibration-profile", default=None,
                    help="path to a CalibrationProfile JSON; the simulated "
                         "modes then plan on fitted link constants")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="write a Chrome trace-event file (open in "
                         "https://ui.perfetto.dev) covering the run: "
                         "per-link utilization tracks, flow lifecycles, "
                         "pager and scheduler/engine spans")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS.json",
                    help="write the metrics snapshot "
                         "(MetricsRegistry.to_json) here")
    ap.add_argument("--recorder-out", default=None, metavar="FLIGHT.json",
                    help="attach a FlightRecorder (bounded ring buffer) "
                         "and write its snapshot here — for --degrade-sim "
                         "the dump is triggered by the first SLO burn "
                         "alert / detector fire and carries the failing "
                         "window's attribution summary")
    ap.add_argument("--recorder-capacity", type=int, default=8192,
                    help="flight-recorder ring size in events")
    ap.add_argument("--openmetrics-out", default=None,
                    metavar="METRICS.txt",
                    help="write an OpenMetrics text exposition snapshot: "
                         "metric counters/gauges plus the bandwidth "
                         "ledger's per-(link, QoS, purpose, request "
                         "class) byte charges and per-link efficiency")
    ap.add_argument("--metrics-listen", default=None, metavar="HOST:PORT",
                    help="after the run, serve the same OpenMetrics "
                         "snapshot over HTTP at /metrics until "
                         "interrupted (a scrape endpoint)")
    ap.add_argument("--recalibrate", action="store_true",
                    help="close the drift loop in --degrade-sim: a "
                         "DriftSentinel flag triggers a single-route "
                         "re-probe + refit + hot-swap (needs "
                         "--calibration-profile)")
    args = ap.parse_args(argv)

    tracer = NULL_TRACER
    if args.trace_out or args.metrics_out or args.openmetrics_out \
            or args.metrics_listen:
        tracer = Tracer()
    recorder = None
    if args.recorder_out:
        # events flow through the ring; an enabled full tracer (from
        # --trace-out/--metrics-out) still sees everything via forward=
        recorder = FlightRecorder(
            capacity=args.recorder_capacity,
            forward=tracer if tracer.enabled else None)
        tracer = recorder
    # --trace-out and the ledger want the full history: the forwarded
    # tracer when a ring-buffer recorder sits in front, the tracer itself
    # otherwise
    full = recorder.forward if (recorder is not None
                                and recorder.forward is not None) \
        else tracer

    if args.paged_sim:
        print(json.dumps(simulate_paged_decode(
            requests=args.requests, gen=args.gen, system_name=args.system,
            step_us=args.step_us,
            calibration_profile=args.calibration_profile, tracer=tracer,
            device=args.device), indent=2))
        _flush_obs(args, tracer, recorder, full)
        return

    if args.disagg_sim:
        from repro_torch.serving.disagg import DisaggConfig, run_disagg_serve
        report = run_disagg_serve(
            DisaggConfig(system=args.system, requests=args.requests,
                         prompt=args.prompt, gen=args.gen,
                         step_us=args.step_us, kv_dtype=args.kv_dtype),
            calibration_profile=args.calibration_profile, tracer=tracer,
            device=args.device)
        print(json.dumps(report.to_json(), indent=2))
        _flush_obs(args, tracer, recorder, full)
        return

    if args.degrade_sim:
        from repro_torch.runtime.degrade import (DegradedServeConfig,
                                                 host_link_degraded,
                                                 run_degraded_serve)
        cfg = DegradedServeConfig(system=args.system,
                                  step_us=args.step_us)
        sched = host_link_degraded(system=args.system,
                                   at_round=args.degrade_round,
                                   factor=args.degrade_factor)
        sentinel = None
        if args.recalibrate:
            if not args.calibration_profile:
                ap.error("--recalibrate needs --calibration-profile "
                         "(the drift sentinel's expectation and the "
                         "recalibrator's profile to hot-swap)")
            from repro_torch.calibrate import CalibrationProfile
            from repro_torch.obs import DriftSentinel
            prof = CalibrationProfile.load(args.calibration_profile)
            sentinel = DriftSentinel(
                prof, preset=args.system,
                tracer=(tracer.scoped("react")
                        if tracer.enabled else tracer))
        react = run_degraded_serve(
            sched, cfg=cfg, react=True,
            calibration_profile=args.calibration_profile,
            sentinel=sentinel, recalibrate=args.recalibrate,
            tracer=tracer.scoped("react") if tracer.enabled else tracer,
            recorder=recorder, device=args.device)
        base = run_degraded_serve(
            sched, cfg=cfg, react=False,
            calibration_profile=args.calibration_profile,
            tracer=tracer.scoped("baseline") if tracer.enabled else tracer,
            device=args.device)
        print(json.dumps({"react": react.to_json(),
                          "baseline": base.to_json()}, indent=2))
        _flush_obs(args, tracer, recorder, full)
        return

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    engine = ServeEngine(cfg, offload_weights=args.offload_weights,
                         device=args.device, tracer=tracer)
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
        "offloaded": args.offload_weights,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "sample": results[0].tokens[:8],
    }))
    _flush_obs(args, tracer, recorder, full)


def _render_openmetrics(tracer, full) -> str:
    return openmetrics_text(metrics=tracer.metrics,
                            ledger=BandwidthLedger.from_tracer(full))


def _flush_obs(args, tracer, recorder, full) -> None:
    """Write what the run observed where the CLI's flags ask; with
    ``--metrics-listen``, then serve it until interrupted. Notes go to
    stderr, so the report stays the last line of stdout."""
    if args.trace_out:
        write_chrome_trace(full, args.trace_out)
        print(f"# trace: {args.trace_out} ({len(full.events)} events; "
              "open in https://ui.perfetto.dev)", file=sys.stderr)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(tracer.metrics.to_json(), f, indent=2, sort_keys=True)
        print(f"# metrics: {args.metrics_out}", file=sys.stderr)
    if args.recorder_out:
        trace = recorder.dump(args.recorder_out)
        meta = trace.get("metadata", {})
        print(f"# flight recorder: {args.recorder_out} "
              f"(reason={meta.get('reason')!r}, {meta.get('events')} "
              f"events, {meta.get('dropped')} dropped; open in "
              "https://ui.perfetto.dev)", file=sys.stderr)
    if args.openmetrics_out:
        write_openmetrics(args.openmetrics_out,
                          _render_openmetrics(tracer, full))
        print(f"# openmetrics: {args.openmetrics_out}", file=sys.stderr)
    if args.metrics_listen:
        host, _, port = args.metrics_listen.rpartition(":")
        server = serve_openmetrics(
            lambda: _render_openmetrics(tracer, full),
            host=host or "127.0.0.1", port=int(port))
        print(f"# metrics: http://{host or '127.0.0.1'}:"
              f"{server.server_port}/metrics (Ctrl-C to stop)",
              file=sys.stderr, flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            server.shutdown()
            server.server_close()


if __name__ == "__main__":
    main()
