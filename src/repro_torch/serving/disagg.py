"""Disaggregated prefill/decode serving over the coherent fabric.

The port of the reference's ``repro/serving/disagg.py``. Every time in its
report is *simulated* on a fabric preset; the decode node's pager holds
the batch's pages on the run's ``device`` (``cuda`` unless the caller asks
for the CPU).

The monolithic ``ServeEngine`` runs both roles on one node — its ``serve``
is literally ``decode(prefill(...))``, a synchronous in-process handoff.
This module costs the disaggregated deployment the paper's pooled-memory
systems make possible: the prefill role runs on one compute node of a
multi-host preset (``cxl_pool``'s ``host1``, ``tpu_v5e``'s ``chip1``), the
decode role on another, and the freshly produced KV pages are *shipped*
across the contended fabric into the decode node's pager.

Three transport decisions shape the run, all made through
``repro_torch.transport`` on the cost model:

  * **route choice** — ``choose_ship_route`` compares the direct
    prefill-memory -> decode path against staging through every other
    reachable memory node (e.g. bouncing HBM pages through host DRAM when
    the chip-to-chip link is degraded) under the actual background
    traffic, and picks the cheapest contended estimate;
  * **overlap** — page shipments start the moment their sequence's prefill
    finishes (``PageTransfer.start``), so shipping overlaps both later
    prefills and earlier sequences' decode steps; the decode node admits
    each sequence as *its* pages land (``launch.serve.admission_schedule``
    — the same deadline-aware loop the tiered pager uses), instead of the
    synchronous baseline's wait-for-everything handoff;
  * **compression** — with ``kv_dtype="int8"`` pages cross the wire in the
    pager's quantized cold-tier layout (~2x fewer bytes), exactly the
    fetch-path compression, applied to the ship path.

``run_disagg_serve`` returns a ``DisaggReport`` whose headline is
``overlap_speedup``: synchronous-handoff makespan over the overlapped
run's mean completion (the ``DecodeSchedule.speedup`` metric, here
measuring prefill/ship/decode pipelining rather than tier prefetch).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.models.context import resolve_device
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.transport import PageTransfer, Route, plan_transfers


@dataclasses.dataclass(frozen=True)
class DisaggRoles:
    """Node bindings of a disaggregated deployment on one System."""
    prefill: str        # compute node running the prompt passes
    decode: str         # compute node stepping the decode batch
    prefill_mem: str    # memory node holding freshly produced KV


def default_roles(system, *, decode: Optional[str] = None,
                  prefill: Optional[str] = None) -> DisaggRoles:
    """Bind roles on a preset: decode on the reference compute node,
    prefill on the first *other* compute node, prefill KV in the memory
    node nearest (unloaded route latency) to the prefill node.

    Raises ``ValueError`` on single-compute systems — there is no second
    node to disaggregate onto.
    """
    computes = system.compute_nodes()
    decode = decode or system.compute
    if decode not in computes:
        raise ValueError(f"{system.name}: decode node {decode!r} is not a "
                         f"compute node; have {computes}")
    if prefill is None:
        others = [c for c in computes if c != decode]
        if not others:
            raise ValueError(
                f"{system.name}: disaggregation needs a second compute "
                f"node (only {computes}); run the monolithic engine")
        prefill = others[0]
    elif prefill not in computes:
        raise ValueError(f"{system.name}: prefill node {prefill!r} is not "
                         f"a compute node; have {computes}")
    best = None
    for m in system.fabric.memory_nodes():
        r = Route.try_resolve(system, m.name, prefill)
        if r is None:
            continue
        if best is None or r.latency < best[0]:
            best = (r.latency, m.name)
    if best is None:
        raise ValueError(f"{system.name}: no memory node reachable from "
                         f"prefill node {prefill!r}")
    return DisaggRoles(prefill=prefill, decode=decode, prefill_mem=best[1])


@dataclasses.dataclass(frozen=True)
class ShipChoice:
    """The shipment path the cost model picked for one sequence's KV."""
    staging: Optional[str]       # memory node staged through; None = direct
    leg1: Optional[Route]        # prefill_mem -> staging (None when direct)
    route: Route                 # final leg into the decode node
    est_time: float              # winning contended per-seq estimate (s)
    considered: dict             # candidate label -> contended estimate (s)


def choose_ship_route(system, roles: DisaggRoles, nbytes: int, *,
                      background: Sequence = (), weight: float = 1.0,
                      priority: int = 0) -> ShipChoice:
    """Pick the cheapest path for ``nbytes`` of KV from the prefill
    memory into the decode node, under ``background`` traffic.

    Candidates: the direct route, plus two-leg staging through every other
    memory node reachable from both ends (HBM pages bounced through host
    DRAM when the chip-to-chip link is degraded — the route the nominal
    cost model would never pick, and the calibrated one does when the
    fitted ICI constant collapses). Estimates are QoS-aware contended
    transfer times from ``Route``; an unreachable or starved candidate
    simply never wins (``inf``).
    """
    considered: dict = {}
    best = None
    direct = Route.try_resolve(system, roles.prefill_mem, roles.decode)
    if direct is not None:
        t = direct.contended_transfer_time(nbytes, background,
                                           weight=weight, priority=priority)
        considered["direct"] = t
        best = (t, None, None, direct)
    for m in system.fabric.memory_nodes():
        if m.name == roles.prefill_mem:
            continue
        leg1 = Route.try_resolve(system, roles.prefill_mem, m.name)
        leg2 = Route.try_resolve(system, m.name, roles.decode)
        if leg1 is None or leg2 is None:
            continue
        t = (leg1.contended_transfer_time(nbytes, background, weight=weight,
                                          priority=priority)
             + leg2.contended_transfer_time(nbytes, background,
                                            weight=weight,
                                            priority=priority))
        considered[f"via:{m.name}"] = t
        if best is None or t < best[0]:
            best = (t, m.name, leg1, leg2)
    if best is None:
        raise ValueError(f"{system.name}: no shipment path from "
                         f"{roles.prefill_mem!r} to {roles.decode!r}")
    return ShipChoice(staging=best[1], leg1=best[2], route=best[3],
                      est_time=best[0], considered=considered)


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Knobs of the simulated disaggregated serve."""
    system: str = "cxl_pool"
    requests: int = 8
    prompt: int = 1024
    gen: int = 24
    page_size: int = 64
    kv_heads: int = 8
    head_dim: int = 128
    kv_dtype: Optional[str] = None      # "int8" -> compressed ship
    step_us: float = 100.0              # decode step on the decode node
    prefill_us_per_token: float = 2.0   # sequential prompt pass rate
    ship_weight: float = 1.0            # DMA QoS class of page shipments
    ship_priority: int = 1              # rides over best-effort co-tenants
    slo_slack: float = 1.5              # deadline = slack * uncontended run
    background: tuple = ()              # co-tenant fabric Flows


@dataclasses.dataclass
class DisaggReport:
    """One disaggregated serve run: roles, route, shipment, schedule."""
    config: DisaggConfig
    system_name: str
    provenance: str              # nominal presets vs calibrated fit
    roles: DisaggRoles
    choice: ShipChoice
    pages_per_seq: int
    page_bytes: int              # logical bytes per page
    wire_page_bytes: int         # bytes per page on the fabric
    prefill_done: dict           # seq -> prefill completion (s)
    ready: dict                  # seq -> last page ETA on decode node (s)
    deadlines: dict              # seq -> SLO completion deadline (s)
    schedule: object             # launch.serve.DecodeSchedule
    plan: object                 # transport.TransferPlan of the shipment
    attribution: Optional[dict] = None   # per-request critical-path
    slo: Optional[dict] = None           # SLOMonitor.report() snapshot
    telemetry: Optional[dict] = None     # per-role window aggregators +
    #                                      the merged fleet view

    @property
    def overlap_speedup(self) -> float:
        """Synchronous-handoff makespan / overlapped mean completion."""
        return self.schedule.speedup

    def to_json(self) -> dict:
        sched = self.schedule
        slack = {s: self.deadlines[s] - sched.finish_time[s]
                 for s in self.deadlines if s in sched.finish_time}
        out = {
            "system": self.system_name,
            "provenance": self.provenance,
            "roles": dataclasses.asdict(self.roles),
            "route": {
                "path": self.choice.route.label,
                "staging": self.choice.staging,
                "bottleneck_GiB_s": round(
                    self.choice.route.bottleneck_bw / (1 << 30), 2),
                "latency_us": round(self.choice.route.latency * 1e6, 3),
                "considered": {k: round(v, 6) for k, v in
                               self.choice.considered.items()},
            },
            "requests": self.config.requests,
            "pages_per_seq": self.pages_per_seq,
            "page_bytes": self.page_bytes,
            "wire_page_bytes": self.wire_page_bytes,
            "shipped_logical_bytes": self.plan.logical_bytes,
            "shipped_wire_bytes": self.plan.wire_bytes,
            "prefill_done_s": {s: round(t, 6)
                               for s, t in self.prefill_done.items()},
            "ready_s": {s: round(t, 6) for s, t in self.ready.items()},
            "deadline_s": {s: round(t, 6)
                           for s, t in self.deadlines.items()},
            "deadline_slack_s": {s: round(v, 6) for s, v in slack.items()},
            "deadline_violations": {s: round(v, 6) for s, v in
                                    sched.violations.items()},
            "first_admit_s": round(
                min(sched.admit_time.values(), default=0.0), 6),
            "makespan_s": round(sched.makespan, 6),
            "sync_makespan_s": round(sched.sync_makespan, 6),
            "mean_completion_s": round(sched.mean_completion, 6),
            "overlap_speedup": round(self.overlap_speedup, 3),
        }
        if self.attribution is not None:
            out["attribution"] = self.attribution
        if self.slo is not None:
            out["slo"] = self.slo
        if self.telemetry is not None:
            out["telemetry"] = self.telemetry
        return out


def run_disagg_serve(cfg: DisaggConfig = DisaggConfig(), *, system=None,
                     calibration_profile=None, slo=None,
                     tracer=NULL_TRACER, device=None) -> DisaggReport:
    """Simulate one disaggregated serve on ``cfg.system`` (or an explicit
    ``system`` — e.g. a degraded or calibrated one).

    The prefill node runs the prompt passes back to back (sequence ``s``
    finishes at ``(s+1) * prompt * prefill_us_per_token``); each sequence's
    KV pages ship over the chosen route the moment its prefill completes,
    chained on one DMA queue against ``cfg.background``; the decode node's
    pager holds the landed pages and ``admission_schedule`` fires decode
    steps as sequences become resident. Deadlines are SLO-shaped: each
    sequence must finish within ``slo_slack`` times its own uncontended
    ship+decode run, counted from its prefill completion.

    With an enabled tracer the report carries the per-request critical-path
    attribution (prefill -> ship-leg link waits -> scheduler wait ->
    decode), and ``slo`` (a ``repro_torch.obs.SLOMonitor``, or the default
    one built when tracing) is fed one end-to-end latency per sequence
    under class ``"interactive"`` — its snapshot rides along in the report.

    ``calibration_profile`` (a ``CalibrationProfile`` or a path to its JSON
    artifact) plans on the calibrated machine's fitted link constants. The
    decode node's pager lives on ``device`` (default ``cuda``; raises if
    there is none).
    """
    from repro_torch.launch.serve import admission_schedule
    from repro_torch.obs.attribution import (attribute_requests,
                                             attribution_summary,
                                             event_cursor, events_since)
    from repro_torch.serving.pager import PagedKVCache, PagerConfig

    device = resolve_device(device)
    cursor = event_cursor(tracer) if tracer.enabled else 0

    if system is None:
        if calibration_profile is not None:
            from repro_torch.calibrate.profile import load_profile
            from repro_torch.fabric.systems import from_profile
            system = from_profile(load_profile(calibration_profile),
                                  preset=cfg.system)
        else:
            from repro_torch.fabric.systems import get_system
            system = get_system(cfg.system)
    roles = default_roles(system)

    # Decode node's pager: every shipped page lands in its fast tier
    # (weights=(1, 0)); the pool is sized for exactly this batch.
    pages_per_seq = -(-cfg.prompt // cfg.page_size)
    cache = PagedKVCache(PagerConfig(
        page_size=cfg.page_size,
        n_pages=cfg.requests * pages_per_seq + 8,
        kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, weights=(1, 0),
        dtype="bfloat16", kv_dtype=cfg.kv_dtype), tracer=tracer,
        device=device)
    kv = torch.zeros((cfg.prompt, cfg.kv_heads, cfg.head_dim),
                     dtype=torch.bfloat16, device=device)
    seqs = list(range(cfg.requests))
    for s in seqs:
        cache.allocate(s)
        cache.append(s, kv, kv)

    # Sequential prefill on the prefill node; ship each sequence's pages
    # as soon as its prompt pass completes.
    done = {s: (s + 1) * cfg.prompt * cfg.prefill_us_per_token * 1e-6
            for s in seqs}
    wire_page = (cache.host_page_bytes if cfg.kv_dtype == "int8"
                 else cache.page_bytes)
    compression = cache.page_bytes / wire_page
    seq_wire = pages_per_seq * wire_page
    choice = choose_ship_route(system, roles, seq_wire,
                               background=cfg.background,
                               weight=cfg.ship_weight,
                               priority=cfg.ship_priority)
    # Staged path: the first leg delays each sequence's arrival at the
    # staging node; the contended second leg is what the event sim runs.
    leg1_t = 0.0
    if choice.leg1 is not None:
        leg1_t = choice.leg1.contended_transfer_time(
            seq_wire, cfg.background, weight=cfg.ship_weight,
            priority=cfg.ship_priority)
    transfers = tuple(
        PageTransfer(p, cache.page_bytes, compression=compression,
                     weight=cfg.ship_weight, priority=cfg.ship_priority,
                     start=done[s] + leg1_t)
        for s in seqs for p in cache.tables[s])
    plan = plan_transfers(choice.route, transfers,
                          background=cfg.background, flow_prefix="ship",
                          probe_weight=cfg.ship_weight,
                          probe_priority=cfg.ship_priority, tracer=tracer)
    ready = {s: max((plan.eta[p] for p in cache.tables[s]), default=done[s])
             for s in seqs}

    step_time = cfg.step_us * 1e-6
    uncontended = choice.route.transfer_time(
        pages_per_seq * cache.page_bytes, compression=compression)
    if choice.leg1 is not None:
        uncontended += choice.leg1.transfer_time(
            pages_per_seq * cache.page_bytes, compression=compression)
    deadlines = {s: done[s] + cfg.slo_slack *
                 (uncontended + cfg.gen * step_time) for s in seqs}
    seq_flows = {s: [f"ship{p}" for p in cache.tables[s]] for s in seqs}
    starts = {s: s * cfg.prompt * cfg.prefill_us_per_token * 1e-6
              for s in seqs}
    sched = admission_schedule(ready, plan, cfg.gen, step_time,
                               deadlines=deadlines, seq_flows=seq_flows,
                               starts=starts, prefill_done=done,
                               tracer=tracer)
    report = DisaggReport(
        config=cfg, system_name=system.name,
        provenance=choice.route.provenance, roles=roles, choice=choice,
        pages_per_seq=pages_per_seq, page_bytes=cache.page_bytes,
        wire_page_bytes=wire_page, prefill_done=done, ready=ready,
        deadlines=deadlines, schedule=sched, plan=plan)
    if tracer.enabled or slo is not None:
        from repro_torch.obs.slo import SLOMonitor
        monitor = slo if slo is not None else SLOMonitor(tracer=tracer)
        monitor.add_class(
            "interactive",
            slo_s=cfg.slo_slack * (uncontended + cfg.gen * step_time))
        for s in seqs:
            if s not in sched.finish_time:
                continue
            monitor.observe("interactive", sched.finish_time[s] - done[s],
                            ts=sched.finish_time[s],
                            violated=s in sched.violations)
        report.slo = monitor.report()
    if tracer.enabled:
        attrs = attribute_requests(events_since(tracer, cursor))
        report.attribution = {
            "requests": {s: a.to_json() for s, a in sorted(attrs.items())},
            "summary": attribution_summary(attrs),
        }
        m = tracer.metrics
        m.set("disagg.overlap_speedup", report.overlap_speedup,
              system=system.name)
        m.add("disagg.shipped_wire_bytes", plan.wire_bytes,
              route=choice.route.label, provenance=choice.route.provenance)
        m.add("disagg.deadline_violations", len(sched.violations),
              system=system.name)
        # per-role windowed telemetry rolled up into one fleet view: each
        # role aggregates only what it can see locally; the merge is the
        # collector's view after scraping both roles
        from repro_torch.obs.timeseries import WindowAggregator
        win = max(sched.makespan / 8.0, 1e-9)
        pre_agg = WindowAggregator(window_s=win)
        dec_agg = WindowAggregator(window_s=win)
        per_seq_wire = pages_per_seq * wire_page
        for s, t in sorted(done.items()):
            pre_agg.observe_counter("role.requests", 1, ts=t,
                                    role="prefill")
            pre_agg.observe_latency("prefill.latency", t, ts=t)
        for s, t in sorted(sched.finish_time.items()):
            dec_agg.observe_counter("role.requests", 1, ts=t,
                                    role="decode")
            dec_agg.observe_counter("ship.wire_bytes", per_seq_wire,
                                    ts=ready[s], role="decode")
            dec_agg.observe_latency("decode.completion", t - done[s],
                                    ts=t)
        fleet = WindowAggregator(window_s=win)
        fleet.merge(pre_agg).merge(dec_agg)
        report.telemetry = {
            "window_s": win,
            "roles": {"prefill": pre_agg.to_json(),
                      "decode": dec_agg.to_json()},
            "fleet": fleet.to_json(),
        }
    return report
