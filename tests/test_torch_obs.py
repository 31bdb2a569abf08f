"""repro_torch.obs vs the reference's repro.obs, value for value.

Every module of ``repro.obs`` is pure Python with no JAX, and the port's
copies must equal it exactly: each test feeds one input (a seeded latency
stream, a fabric-simulator run, a recorded scheduler stream) through both
packages and compares the results as JSON text, so the tolerance is
equality. The fabric streams are produced by each package's own simulator
(they must match event for event); the attribution streams come from a
disaggregated serve run, recorded once with the reference's and once with
the port's (``device="cpu"``), and each is replayed through both
packages' ``TraceEvent``s.
"""

import importlib
import json
import math
import random
import urllib.error
import urllib.request

import pytest

MiB = 1 << 20
SIDES = ("repro", "repro_torch")


def mod(side: str, name: str):
    return importlib.import_module(f"{side}.{name}")


def text(x) -> str:
    """A result as canonical JSON text (tuples as lists, NaN kept)."""
    return json.dumps(x, sort_keys=True, default=_plain)


def _plain(x):
    if hasattr(x, "to_json"):
        return x.to_json()
    if hasattr(x, "_asdict"):
        return list(x)
    raise TypeError(f"cannot compare {type(x).__name__}")


def same(fn):
    """Run ``fn(side)`` for the reference and the port; both results must
    be equal as JSON text. Returns the port's."""
    want, got = (fn(side) for side in SIDES)
    assert text(got) == text(want)
    return got


def _events(tracer) -> list:
    return [tuple(e) for e in tracer.events]


# ---------------------------------------------------------------------------
# slo: histograms, percentiles, merge, JSON, burn-rate alerts
# ---------------------------------------------------------------------------


def _stream(seed: int, n: int = 2000) -> list:
    rng = random.Random(seed)
    return [math.exp(rng.gauss(-6.0, 1.5)) for _ in range(n)]


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, {"buckets_per_decade": 32}),
    (2, {"lo": 1e-3, "hi": 1.0}), (3, {"buckets_per_decade": 128})])
def test_histogram_percentiles_match_reference(seed, kw):
    def run(side):
        h = mod(side, "obs").LatencyHistogram(**kw)
        for v in _stream(seed) + [1e-9, -1.0, 500.0]:   # clamps too
            h.record(v)
        return {"json": h.to_json(), "count": h.count,
                "bound": h.rel_error_bound,
                "p": [h.percentile(q) for q in (0, 1, 25, 50, 90, 95, 99,
                                               99.9, 100)]}
    same(run)


@pytest.mark.parametrize("seeds", [(1, 2), (3, 4, 5)])
def test_histogram_merge_and_json_round_trip_match_reference(seeds):
    def run(side):
        H = mod(side, "obs").LatencyHistogram
        parts = []
        for s in seeds:
            h = H()
            for v in _stream(s, 300):
                h.record(v)
            parts.append(H.from_json(h.to_json()))
        merged = parts[0]
        for h in parts[1:]:
            merged = merged.merge(h)
        with pytest.raises(ValueError, match="shapes differ"):
            merged.merge(H(buckets_per_decade=32))
        return {"merged": merged.to_json(),
                "p99": merged.percentile(99)}
    same(run)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_monitor_burn_alerts_match_reference(seed):
    """A seeded latency stream with bursts of violations: the same alerts
    (rising edges), clears, trace events and report."""
    rng = random.Random(seed)
    obs = []
    for i in range(120):
        burst = (i // 15) % 2 == 1
        cls = "api" if i % 3 else "batch"
        lat = rng.uniform(0.2, 0.6) if burst else rng.uniform(0.001, 0.05)
        obs.append((cls, lat, float(i)))

    def run(side):
        o = mod(side, "obs")
        tr = o.Tracer(clock=lambda: 0.0)
        alerts = []
        mon = o.SLOMonitor({"api": 0.1}, budget_frac=0.1, burn_threshold=2.0,
                           short_window=6, long_window=18, min_samples=4,
                           tracer=tr,
                           on_alert=lambda c, info: alerts.append((c, info)))
        mon.add_class("batch", 0.3)
        mon.add_class("api", 99.0)              # keeps the first budget
        verdicts = [mon.observe(c, v, ts=ts) for c, v, ts in obs]
        verdicts.append(mon.observe("free", 5.0))           # no budget
        verdicts.append(mon.observe("free", 1e-3, violated=True))
        return {"verdicts": verdicts, "alerts": alerts,
                "alerting": [mon.alerting(c) for c in ("api", "batch")],
                "p95": mon.percentile("api", 95), "report": mon.report(),
                "events": _events(tr),
                "metrics": tr.metrics.to_json()}
    got = same(run)
    assert got["alerts"]                          # the stream does alert


# ---------------------------------------------------------------------------
# export: the golden trace, fabric runs, the incremental writer, repairs
# ---------------------------------------------------------------------------


def _qos_flows(side):
    Flow = mod(side, "fabric.contention").Flow
    return [Flow("offload", "host_dram", "chip0", 512 * MiB),
            Flow("kv_prefetch", "host_dram", "chip0", 64 * MiB, priority=1)]


def _sim(side, system, flows, tracer):
    return mod(side, "fabric.sim").simulate(
        mod(side, "fabric.systems").get_system(system).fabric, flows,
        tracer=tracer)


def test_golden_trace_reproduced_byte_for_byte():
    """tests/golden/obs_qos_trace.json, which the reference's test_obs
    pins, written by the port's simulator and exporter."""
    import pathlib
    from repro_torch.obs import Tracer, chrome_trace, validate_chrome_trace
    tr = Tracer(clock=lambda: 0.0)
    _sim("repro_torch", "tpu_v5e", _qos_flows("repro_torch"), tr)
    trace = chrome_trace(tr)
    validate_chrome_trace(trace)
    golden = pathlib.Path(__file__).parent / "golden" / "obs_qos_trace.json"
    assert json.dumps(trace, indent=1) == golden.read_text()


def _random_flows(side, seed: int):
    Flow = mod(side, "fabric.contention").Flow
    rng = random.Random(seed)
    routes = [("host_dram", "chip0"), ("host_dram", "hbm0"),
              ("hbm1", "chip0"), ("host_dram", "chip1")]
    names = ["page", "ship", "bulk_offload", "migrate_", "probe", "x"]
    flows = []
    for i in range(rng.randint(2, 7)):
        src, dst = rng.choice(routes)
        flows.append(Flow(f"{names[i % len(names)]}{i}", src, dst,
                          rng.randint(1, 64) * MiB,
                          priority=rng.randint(0, 2),
                          weight=rng.choice([1.0, 2.0, 4.0]),
                          start=rng.randint(0, 20) * 1e-3))
    return flows


FABRIC_RUNS = ["qos", "seed0", "seed1", "seed2", "seed3", "idle_gap"]


def _fabric_run(side, name):
    """One simulator run, traced, in the port or the reference."""
    o = mod(side, "obs")
    tr = o.Tracer(clock=lambda: 0.0)
    if name == "qos":
        flows = _qos_flows(side)
    elif name == "idle_gap":
        Flow = mod(side, "fabric.contention").Flow
        flows = [Flow("early", "host_dram", "chip0", 8 * MiB),
                 Flow("late", "host_dram", "chip0", 8 * MiB, start=10.0)]
    else:
        flows = _random_flows(side, int(name[4:]))
    results = _sim(side, "tpu_v5e", flows, tr)
    return tr, results


@pytest.mark.parametrize("run", FABRIC_RUNS)
def test_chrome_trace_and_timelines_match_reference(run):
    def go(side):
        o = mod(side, "obs")
        tr, _ = _fabric_run(side, run)
        trace = o.chrome_trace(tr)
        o.validate_chrome_trace(trace)
        tls = o.link_timelines(tr)
        return {"trace": trace, "events": _events(tr),
                "timelines": {k: [t.capacity, list(t.samples),
                                  t.bytes_moved(), t.bytes_by_class(),
                                  t.max_utilization(), t.end_ts]
                              for k, t in tls.items()}}
    same(go)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_incremental_writer_equals_one_shot(chunk):
    def go(side):
        o = mod(side, "obs")
        tr, _ = _fabric_run(side, "seed1")
        w = o.ChromeTraceWriter()
        events = list(tr.events)
        for i in range(0, len(events), chunk):
            w.extend(events[i:i + chunk])
        assert text(w.trace()) == text(o.chrome_trace(tr))
        o.validate_chrome_trace(w.trace())
        return w.trace()
    same(go)


def test_write_chrome_trace_files_match_reference(tmp_path):
    def go(side):
        o = mod(side, "obs")
        tr, _ = _fabric_run(side, "qos")
        path = tmp_path / f"{side}.json"
        o.write_chrome_trace(tr, str(path))
        return path.read_text()
    same(go)


def _truncated(side):
    TraceEvent = mod(side, "obs.trace").TraceEvent
    trk = ("p", "t")
    return [TraceEvent("E", "lost", 0.5, trk, "", None, None),
            TraceEvent("e", "flow0", 0.6, trk, "flow", "f0", None),
            TraceEvent("B", "outer", 1.0, trk, "", None, None),
            TraceEvent("b", "flow1", 1.5, trk, "flow", "f1", None),
            TraceEvent("B", "inner", 1.7, trk, "", None, {"k": 1}),
            TraceEvent("i", "mark", 2.0, trk, "", None, None)]


def test_recorder_trace_repairs_match_reference():
    def go(side):
        o = mod(side, "obs")
        trace = o.recorder_trace(_truncated(side),
                                 metadata={"reason": "test"})
        o.validate_chrome_trace(trace)
        return trace
    got = same(go)
    assert sum(1 for e in got["traceEvents"]
               if (e.get("args") or {}).get("truncated")) == 3


BAD_TRACES = {
    "out of order": [
        {"ph": "i", "name": "a", "pid": 1, "tid": 1, "ts": 2.0},
        {"ph": "i", "name": "b", "pid": 1, "tid": 1, "ts": 1.0}],
    "E without B": [{"ph": "E", "name": "x", "pid": 1, "tid": 1, "ts": 0.0}],
    "unclosed B": [{"ph": "B", "name": "x", "pid": 1, "tid": 1, "ts": 0.0}],
    "mismatched span nesting": [
        {"ph": "B", "name": "x", "pid": 1, "tid": 1, "ts": 0.0},
        {"ph": "E", "name": "y", "pid": 1, "tid": 1, "ts": 1.0}],
    "async end without begin": [
        {"ph": "e", "name": "f", "pid": 1, "tid": 1, "ts": 0.0,
         "cat": "flow", "id": "f"}],
}


@pytest.mark.parametrize("why", sorted(BAD_TRACES))
def test_validate_rejects_as_reference(why):
    def go(side):
        with pytest.raises(ValueError) as err:
            mod(side, "obs").validate_chrome_trace(
                {"traceEvents": BAD_TRACES[why]})
        return str(err.value)
    assert why in same(go)


# ---------------------------------------------------------------------------
# recorder: ring, forward, snapshot, dump
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [2, 8, 4096])
def test_flight_recorder_matches_reference(capacity, tmp_path):
    def go(side):
        o = mod(side, "obs")
        full = o.Tracer(clock=lambda: 0.0)
        rec = o.FlightRecorder(capacity=capacity, forward=full)
        _sim(side, "tpu_v5e", _qos_flows(side), rec)
        cur = o.event_cursor(rec)
        rec.instant("late", ts=9.0)
        snap = rec.snapshot(reason="unit", attribution={"requests": 0},
                            ts=1.0)
        o.validate_chrome_trace(snap)
        path = tmp_path / f"{side}.json"
        rec.dump(str(path))
        return {"snap": snap, "dump": path.read_text(),
                "emitted": rec.emitted, "dropped": rec.dropped,
                "since": [tuple(e) for e in o.events_since(rec, cur)],
                "forwarded": _events(full), "ring": _events(rec)}
    got = same(go)
    assert (got["dropped"] > 0) == (capacity < 100)


def test_flight_recorder_rejects_empty_ring_as_reference():
    def go(side):
        with pytest.raises(ValueError) as err:
            mod(side, "obs").FlightRecorder(capacity=0)
        return str(err.value)
    same(go)


# ---------------------------------------------------------------------------
# timeseries: windows, merge, the OpenMetrics text, the scrape endpoint
# ---------------------------------------------------------------------------


def _aggregators(side):
    o = mod(side, "obs")
    rng = random.Random(7)
    pre = o.WindowAggregator(window_s=0.5, horizon=8)
    dec = o.WindowAggregator(window_s=0.5, horizon=8)
    for i in range(60):
        ts = i * 0.11
        pre.observe_counter("req", rng.randint(1, 5), ts=ts, role="prefill")
        dec.observe_counter("req", rng.randint(1, 5), ts=ts, role="decode")
        dec.observe_gauge("depth", rng.randint(0, 9), ts=ts, role="decode")
        pre.observe_latency("lat", rng.uniform(1e-3, 5e-2), ts=ts)
        dec.observe_latency("lat", rng.uniform(1e-3, 5e-2), ts=ts)
    m = o.MetricsRegistry()
    m.add("bytes", 100, link="l0")
    dec.ingest_metrics(m, ts=6.5)
    m.add("bytes", 300, link="l0")
    m.set("util", 0.7, link='weird"link\\name|a=b')
    dec.ingest_metrics(m, ts=7.0)
    fleet = o.WindowAggregator(window_s=0.5, horizon=8).merge(pre).merge(dec)
    return o, pre, dec, fleet, m


def test_window_aggregator_matches_reference():
    def go(side):
        o, pre, dec, fleet, _ = _aggregators(side)
        with pytest.raises(ValueError, match="window sizes differ"):
            fleet.merge(o.WindowAggregator(window_s=1.0))
        return {name: {"json": a.to_json(), "windows": a.window_indices(),
                       "rates": [a.rates(w) for w in a.window_indices()],
                       "latest": a.rates(),
                       "quantiles": [a.quantiles(w)
                                     for w in a.window_indices()]}
                for name, a in (("pre", pre), ("dec", dec),
                                ("fleet", fleet))}
    same(go)


def _exposition(side):
    o, _, _, fleet, m = _aggregators(side)
    tr, _ = _fabric_run(side, "seed2")
    for k, v in tr.metrics.to_json()["counters"].items():
        name, labels = o.parse_key(k)
        m.add(name, v, **labels)
    h = o.LatencyHistogram()
    for v in _stream(5, 50):
        h.record(v)
    return o.openmetrics_text(
        metrics=m, aggregator=fleet, histograms={"serve.latency": h},
        ledger=o.BandwidthLedger.from_tracer(
            tr, ceilings=o.link_ceilings(
                mod(side, "fabric.systems").get_system("tpu_v5e"))))


def test_openmetrics_text_equals_reference_as_strings():
    got = same(_exposition)
    assert got.endswith("# EOF\n")
    assert "repro_ledger_bytes_total{" in got


def test_serve_openmetrics_scrape_and_file(tmp_path):
    from repro_torch.obs import (OPENMETRICS_CONTENT_TYPE, serve_openmetrics,
                                 write_openmetrics)
    want = _exposition("repro")
    server = serve_openmetrics(lambda: _exposition("repro_torch"), port=0)
    try:
        url = f"http://127.0.0.1:{server.server_port}"
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as resp:
            assert resp.read().decode("utf-8") == want
            assert resp.headers["Content-Type"] == OPENMETRICS_CONTENT_TYPE
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{url}/nope", timeout=30)
    finally:
        server.shutdown()
        server.server_close()
    path = tmp_path / "m.txt"
    write_openmetrics(str(path), want)
    assert path.read_text() == want


@pytest.mark.parametrize("label", ["plain", "a|b", "a=b", "x[0]",
                                   "back\\slash", "p|q=r[s]\\t", ""])
def test_metric_keys_round_trip_as_reference(label):
    def go(side):
        m = mod(side, "obs.metrics")
        key = m._key("m.name", {"route": label, "a|b": label})
        return [key, m.parse_key(key)]
    same(go)


# ---------------------------------------------------------------------------
# ledger: the same fabric streams charged to the same cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", FABRIC_RUNS)
def test_bandwidth_ledger_matches_reference(run):
    def go(side):
        o = mod(side, "obs")
        tr, results = _fabric_run(side, run)
        led = o.BandwidthLedger.from_tracer(
            tr, window_s=1e-3, ceilings=o.link_ceilings(
                mod(side, "fabric.systems").get_system("tpu_v5e")))
        return {"entries": led.entries(), "windows": led.windows(),
                "totals": led.link_totals(), "total": led.total_bytes(),
                "efficiency": led.efficiency(),
                "conservation": led.flow_conservation(),
                "timelines": led.reconcile_timelines(o.link_timelines(tr)),
                "metrics": led.reconcile_metrics(tr.metrics),
                "results": led.reconcile_flow_bytes(results),
                "report": led.report()}
    got = same(go)
    assert got["conservation"]["max_rel_err"] <= 1e-6


def test_ledger_scopes_and_sequential_runs_match_reference():
    def go(side):
        o = mod(side, "obs")
        Flow = mod(side, "fabric.contention").Flow
        tr = o.Tracer(clock=lambda: 0.0)
        for scope, nb in (("react", 8), ("baseline", 24), ("react", 8)):
            _sim(side, "tpu_v5e",
                 [Flow("page0", "host_dram", "chip0", nb * MiB,
                       priority=1)], tr.scoped(scope))
        return {p or "all": o.BandwidthLedger.from_tracer(
                    tr, window_s=1e-4, **({"process": p} if p else {})
                ).report()
                for p in ("react", "baseline", None)}
    same(go)


@pytest.mark.parametrize("system", ["tpu_v5e", "gh200", "cxl_pool",
                                    "dual_socket_cxl", "mi300a"])
def test_link_ceilings_and_classifiers_match_reference(system):
    ids = ["page03", "probe1", "ship/s0/p1", "migrate_kv_7", "bulk_offload",
           "weight_spill", "mystery", "MIGRATE_x", "xship", "Offload"]

    def go(side):
        o = mod(side, "obs")
        purposes = [o.classify_purpose(i) for i in ids]
        return {"ceilings": o.link_ceilings(
                    mod(side, "fabric.systems").get_system(system)),
                "purposes": purposes,
                "requests": [o.classify_request(p, q)
                             for p in purposes + ["other"]
                             for q in (0, 1, 2)]}
    same(go)


# ---------------------------------------------------------------------------
# attribution: the critical-path walk over recorded streams
# ---------------------------------------------------------------------------


def _hand_events(side):
    tr = mod(side, "obs").Tracer(clock=lambda: 0.0)
    lt = ("fabric", "links")
    tr.instant("link", ts=0.0, track=lt, cat="fabric.link.meta",
               link="slow", capacity=1e9)
    tr.instant("link", ts=0.0, track=lt, cat="fabric.link.meta",
               link="fast", capacity=1e12)
    tr.async_begin("f0", id="f0", ts=1.0, track=("fabric", "flows"),
                   cat="flow", src="a", dst="b", priority=1,
                   links=["fast", "slow"])
    tr.async_end("f0", id="f0", ts=3.5, track=("fabric", "flows"),
                 cat="flow", drained_ts=3.0)
    tr.instant("attrib.request", ts=0.0,
               track=("scheduler", "attribution"), cat="attrib",
               rid="r0", start=0.0, ready=3.2, flows=["f0"],
               prefill_done=0.5)
    tr.instant("sched.admit", ts=4.0, track=("scheduler", "admission"),
               cat="sched", seq="r0")
    tr.async_begin("seq r0", id="s0", ts=4.0, track=("scheduler", "steps"),
                   cat="sched", seq="r0")
    tr.async_end("seq r0", id="s0", ts=6.0, track=("scheduler", "steps"),
                 cat="sched")
    return list(tr.events)


_RECORDED: dict = {}


def _recorded(name):
    """A stream recorded once with a disaggregated serve (its scheduler
    emits the ``attrib.request`` instants): the reference's, or with a
    ``port_`` prefix the port's."""
    if name not in _RECORDED:
        side, base = ("repro_torch", name[5:]) if name.startswith("port_") \
            else ("repro", name)
        disagg = mod(side, "serving.disagg")
        kw = {"disagg3": dict(requests=3),
              "disagg5_int8": dict(requests=5, kv_dtype="int8"),
              "disagg4_tpu": dict(requests=4, system="tpu_v5e")}[base]
        tr = mod(side, "obs").Tracer(clock=lambda: 0.0)
        disagg.run_disagg_serve(disagg.DisaggConfig(**kw), tracer=tr,
                                **({"device": "cpu"} if side == "repro_torch"
                                   else {}))
        _RECORDED[name] = [tuple(e) for e in tr.events]
    return _RECORDED[name]


def _stream_for(side, name):
    if name == "hand":
        return _hand_events(side)
    TraceEvent = mod(side, "obs.trace").TraceEvent
    return [TraceEvent(*e) for e in _recorded(name)]


@pytest.mark.parametrize("name", ["hand", "disagg3", "disagg5_int8",
                                  "disagg4_tpu", "port_disagg3",
                                  "port_disagg5_int8", "port_disagg4_tpu"])
def test_attribution_matches_reference(name):
    def go(side):
        o = mod(side, "obs")
        events = _stream_for(side, name)
        attrs = o.attribute_requests(events)
        first = sorted(attrs, key=str)[:1]
        return {"requests": {str(k): a.to_json() for k, a in attrs.items()},
                "breakdown": {str(k): a.breakdown()
                              for k, a in attrs.items()},
                "top": {str(k): [a.top(2), a.top_contributor]
                        for k, a in attrs.items()},
                "summary": o.attribution_summary(attrs),
                "filtered": o.attribution_summary(attrs, rids=first),
                "absent": o.attribution_summary(attrs, rids=["absent"])}
    got = same(go)
    assert got["summary"]["requests"] >= 1


@pytest.mark.parametrize("name", ["disagg3", "disagg5_int8", "disagg4_tpu"])
def test_port_recorded_serve_stream_equals_reference_recorded(name):
    """The port's disaggregated serve emits the reference's event stream,
    event for event."""
    assert text(_recorded(f"port_{name}")) == text(_recorded(name))


def test_ledger_on_recorded_serve_stream_matches_reference():
    """The ledger over the serve stream's fabric flows (pages shipped by
    the disaggregated run), replayed in both packages."""
    def go(side):
        led = mod(side, "obs").BandwidthLedger().ingest(
            _stream_for(side, "disagg5_int8"))
        return led.report()
    assert same(go)["total_bytes"] > 0


def test_event_cursor_survives_ring_drops_as_reference():
    def go(side):
        o = mod(side, "obs")
        rec = o.FlightRecorder(capacity=4, clock=lambda: 0.0)
        plain = o.Tracer(clock=lambda: 0.0)
        out = []
        for tr in (rec, plain.scoped("s")):
            for i in range(3):
                tr.instant(f"a{i}", ts=float(i))
            cur = o.event_cursor(tr)
            for i in range(6):
                tr.instant(f"b{i}", ts=float(10 + i))
            out.append([cur, [e.name for e in o.events_since(tr, cur)]])
        return out
    assert same(go)[0][1] == ["b2", "b3", "b4", "b5"]


# ---------------------------------------------------------------------------
# drift: a System expectation; a calibration profile raises in the port
# ---------------------------------------------------------------------------


def _degraded(side, factor=0.5):
    """tpu_v5e with every link of the compute <-> spill-tier route scaled
    by ``factor``: the reference's host_link_degraded, built from the
    fabric primitives both packages have."""
    import dataclasses
    base = mod(side, "fabric.systems").get_system("tpu_v5e")
    spill = base.tier_node(base.kv_tiers[1])
    scales = {(min(l.src, l.dst), max(l.src, l.dst)): (factor, 1.0)
              for l in base.fabric.route(spill, base.compute)}
    return base, dataclasses.replace(
        base, fabric=base.fabric.rescaled(scales,
                                          name=f"{base.name}+degraded"))


def test_degraded_system_equals_reference_schedule():
    from repro.runtime.degrade import host_link_degraded
    base, deg = _degraded("repro")
    want = host_link_degraded().degraded_system(base, 11)
    assert {k: (l.bandwidth, l.latency) for k, l in deg.fabric.links.items()} \
        == {k: (l.bandwidth, l.latency)
            for k, l in want.fabric.links.items()}


def _observe(side, sentinel, system, src, dst, n, ts0=0.0):
    t = mod(side, "transport")
    route = t.Route.resolve(system, src, dst)
    return [sentinel.observe_plan(
                t.plan_transfers(route, (t.PageTransfer(f"{src}-{i}",
                                                        8 * MiB),)),
                ts=ts0 + i)
            for i in range(n)]


def test_drift_sentinel_matches_reference():
    def go(side):
        o = mod(side, "obs")
        base, deg = _degraded(side)
        tr = o.Tracer(clock=lambda: 0.0)
        flags = []
        sent = o.DriftSentinel(base, tracer=tr, min_obs=3,
                               on_flag=lambda r, info: flags.append((r, info)))
        ratios = _observe(side, sent, deg, "host_dram", "chip0", 5)
        ratios += _observe(side, sent, deg, "hbm1", "chip0", 4)
        out = {"ratios": ratios, "flagged": sent.flagged_routes(),
               "drifting": sent.drifting_routes(), "report": sent.report()}
        out["cleared"] = [sent.clear("host_dram->chip0"),
                          sent.clear("no->route")]
        sent.rebase(deg)
        out["after_rebase"] = _observe(side, sent, deg, "host_dram",
                                       "chip0", 4, ts0=50.0)
        out.update(final=sent.report(), flags=flags, events=_events(tr),
                   metrics=tr.metrics.to_json())

        class FakeRoute:
            src, dst = "no_such_tier", "chip0"

        class EmptyPlan:
            transfers = ()
        out["unknown"] = sent.predict(FakeRoute, 1024)
        out["empty"] = sent.observe_plan(EmptyPlan())
        return out
    got = same(go)
    assert got["flagged"] == ["host_dram->chip0"]
    assert len(got["flags"]) == 1


def test_drift_sentinel_from_a_profile_raises_until_calibration():
    """A CalibrationProfile expectation goes through the port's
    from_profile: a profile fitted on another preset is refused with the
    reference's message, and one fitted on this preset predicts what the
    reference's sentinel predicts."""
    import repro.calibrate as rc
    import repro_torch.calibrate as pc
    from repro.obs import DriftSentinel as RefSentinel
    from repro.transport import Route as RefRoute
    from repro_torch.obs import DriftSentinel
    from repro_torch.transport import Route
    msgs = []
    for cal, sentinel in ((rc, RefSentinel), (pc, DriftSentinel)):
        with pytest.raises(ValueError) as e:
            sentinel(cal.CalibrationRunner("cxl_pool").calibrate(),
                     preset="tpu_v5e")
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
    preds = []
    for cal, sentinel, route in ((rc, RefSentinel, RefRoute),
                                 (pc, DriftSentinel, Route)):
        sent = sentinel(cal.CalibrationRunner("tpu_v5e").calibrate())
        r = route.resolve(sent.expected, "host_dram", "chip0")
        preds.append((sent.expected.provenance,
                      sent.predict(r, 8 << 20)))
    assert preds[1] == preds[0] and preds[1][0] == "calibrated"


def test_obs_exports_match_reference():
    import repro.obs as ref
    import repro_torch.obs as port
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert port.DEFAULT_TRACK == ref.DEFAULT_TRACK
    assert port.OPENMETRICS_CONTENT_TYPE == ref.OPENMETRICS_CONTENT_TYPE
    for name in port.__all__:
        obj = getattr(port, name)
        if isinstance(obj, type) or callable(obj):
            assert type(obj).__module__.startswith("repro_torch") \
                or obj.__module__.startswith("repro_torch"), name
