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

``DecodeScheduler`` is the deadline-aware decode loop over a tier-split
``PagedKVCache``: it plans host->HBM page prefetches through the fabric
simulator and admits each sequence into the decode batch at the first step
deadline by which *its* pages have landed (``PrefetchPlan.ready_by``).
``--paged-sim`` reports the fp16-vs-int8 comparison on one page set; the
two pagers' pools live on the device, the schedule is a simulation on the
``--system`` preset (never a measurement of the card):

  python -m repro_torch.launch.serve --paged-sim --system gh200

Weight offload and the ``--disagg-sim`` / ``--degrade-sim`` modes come
with later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.config.base import ParallelConfig, get_config
from repro_torch.models.context import resolve_device
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
                "core/offload.py StreamingParamServer and "
                "ServeEngine(offload_weights=True)) is not ported yet; it "
                "comes with slice 4a, serving offload and observability")
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

    def schedule(self, seq_ids: list, n_steps: int) -> DecodeSchedule:
        """Simulate ``n_steps`` decode steps per sequence, admitting each
        sequence at its pages' arrival (deadline-aware continuous batch)."""
        plan = self.cache.plan_prefetch(seq_ids, system=self.system,
                                        background=self.background,
                                        priority=self.priority)
        ready = self.ready_times(seq_ids, plan)
        return admission_schedule(ready, plan, n_steps, self.step_time,
                                  tracer=self.tracer)


def admission_schedule(ready: dict, plan, n_steps: int, step_time: float,
                       *, tracer=NULL_TRACER) -> DecodeSchedule:
    """The deadline-aware admission loop itself, plan-agnostic.

    ``ready`` maps seq id -> sim time its pages are fully resident (dict
    order is the admission preference order); ``plan`` is anything with
    ``ready_by(t)`` and ``total_time`` — a pager ``PrefetchPlan`` or a
    transport ``TransferPlan`` (the disaggregated prefill->decode shipment
    reuses this loop unchanged: pages landing over the cross-host route
    admit sequences exactly like host->HBM prefetches do).
    """
    seq_ids = list(ready)
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
    sched = DecodeSchedule(tuple(steps), admit, finish, makespan, sync,
                           plan.total_time, step_time)
    if traced:
        m = tracer.metrics
        m.add("sched.steps", len(steps))
        m.add("sched.sequences", len(seq_ids))
        m.set("sched.makespan_s", makespan)
        m.set("sched.mean_completion_s", sched.mean_completion)
        m.set("sched.prefetch_total_s", plan.total_time)
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

    ``calibration_profile`` (the reference's calibrated machine) is not
    ported yet and raises: it comes with the calibration slice. The two
    pagers' pools live on ``device`` (default ``cuda``; raises if there is
    none); the schedule itself is a simulation on the ``system_name``
    preset, not a measurement of the device.

    An enabled ``tracer`` records both runs into one trace, each scoped by
    label — the fp16 run's fabric tracks live under process
    ``"fp16/fabric"``, the int8 run's under ``"int8/fabric"`` — so the two
    contended prefetches can be compared side by side in Perfetto; the
    metrics snapshot is embedded in the report under ``"metrics"``.
    """
    from repro_torch.fabric.contention import Flow
    from repro_torch.fabric.systems import get_system

    if calibration_profile is not None:
        raise NotImplementedError(
            "calibration_profile: calibrated systems are not ported yet; "
            "they come with the calibration slice")
    system = get_system(system_name)
    # fixed-size background stream: both the fp16 and int8 runs must see
    # IDENTICAL contention (an open-ended flow would be auto-sized from
    # each cache's own page bytes, quietly shrinking the int8 background)
    bg = (Flow("offload", "host", "hbm", nbytes=256 << 20),)
    toks = prompt + gen
    out = {"system": system_name, "requests": requests,
           "tokens_per_seq": toks, "step_us": step_us,
           "background": True,
           "calibrated": False}
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
    ap.add_argument("--paged-sim", action="store_true",
                    help="simulated fp16-vs-int8 paged decode scheduling "
                         "report (no model run)")
    ap.add_argument("--system", default="tpu_v5e",
                    help="fabric preset the --paged-sim schedule runs on")
    ap.add_argument("--step-us", type=float, default=100.0,
                    help="decode step time of the --paged-sim schedule")
    ap.add_argument("--metrics-out", default=None, metavar="METRICS.json",
                    help="write the metrics snapshot "
                         "(MetricsRegistry.to_json) here")
    args = ap.parse_args(argv)

    tracer = Tracer() if args.metrics_out else NULL_TRACER
    if args.paged_sim:
        print(json.dumps(simulate_paged_decode(
            requests=args.requests, gen=args.gen, system_name=args.system,
            step_us=args.step_us, tracer=tracer, device=args.device),
            indent=2))
        _write_metrics(args.metrics_out, tracer)
        return
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
    _write_metrics(args.metrics_out, tracer)


def _write_metrics(path, tracer) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(tracer.metrics.to_json(), f, indent=2, sort_keys=True)


if __name__ == "__main__":
    main()
