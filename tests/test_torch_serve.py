"""repro_torch ServeEngine vs the reference's, on reduced yi-9b.

The reference engine runs the Pallas flash kernel in interpret mode
(``attention_kernel="pallas"``); the port's runs its ``"kernel"`` path,
which on CPU tensors is the kernel's plain version. Both cast their weights
to bf16; fp32 activations keep argmax ties away, so the generated tokens
must be identical, with the weights on the device or offloaded to the host
tier (``offload_weights=True``, a whole-tree fetch on every call).
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.config.base import get_config as jax_get_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import ServeEngine as JaxServeEngine
from repro.obs.trace import Tracer as JaxTracer
from repro_torch.config.base import get_config
from repro_torch.launch import serve
from repro_torch.models.params import params_from_jax
from repro_torch.obs.trace import Tracer

PROMPT_LENS, MAX_NEW = (16, 15, 14), 4


@pytest.fixture(scope="module")
def engines():
    cfg = jax_get_config("yi-9b").reduced(dtype="float32")
    ref = JaxServeEngine(cfg, parallel=JaxParallelConfig(
        fsdp=False, attention_kernel="pallas"), tracer=JaxTracer())
    port = serve.ServeEngine(get_config("yi-9b").reduced(dtype="float32"),
                             device="cpu", tracer=Tracer())
    port.model.set_params(params_from_jax(
        jax.tree.map(np.asarray, ref.params_home), "cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    ref_out = ref.serve([JaxRequest(i, p, MAX_NEW)
                         for i, p in enumerate(prompts)])
    port_out = port.serve([serve.Request(i, p, MAX_NEW)
                           for i, p in enumerate(prompts)])
    return ref, port, ref_out, port_out


def test_tokens_match_reference(engines):
    _, _, ref_out, port_out = engines
    assert [r.rid for r in port_out] == [r.rid for r in ref_out]
    for got, want in zip(port_out, ref_out):
        assert len(got.tokens) == MAX_NEW
        assert got.tokens == want.tokens, got.rid


def test_spans_and_metrics_match_reference(engines):
    ref, port, _, _ = engines

    def shape(tracer):
        return [(e.kind, e.name, e.track) for e in tracer.events]
    assert shape(port.tracer) == shape(ref.tracer)
    names = {e.name for e in port.tracer.events}
    assert {"serve.prefill", "serve.decode_step"} <= names
    got, want = port.tracer.metrics.to_json(), ref.tracer.metrics.to_json()
    assert got["counters"] == want["counters"]
    assert got["gauges"].keys() == want["gauges"].keys()
    assert any(k.startswith("serve.straggler.") for k in got["gauges"])
    assert got["gauges"]["serve.straggler.n"] == MAX_NEW


def test_cli_serves_on_cpu(tmp_path, capsys):
    out = tmp_path / "metrics.json"
    serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                "--prompt", "12", "--gen", "3", "--metrics-out", str(out)])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["requests"] == 2 and report["device"] == "cpu"
    assert len(report["sample"]) == 3
    assert json.loads(out.read_text())["counters"]["serve.decode_steps"] == 3


# ---------------------------------------------------------------------------
# Weight offload: the paper's sync mode (a whole-tree fetch on every call)
# ---------------------------------------------------------------------------


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, n).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def offloaded(engines):
    """The reference's offloaded engine and the port's, on the reference's
    weights, each with an SLO monitor whose 1 ns budget every request
    violates."""
    from repro.obs import SLOMonitor as JaxSLOMonitor
    from repro_torch.obs import SLOMonitor
    cfg = jax_get_config("yi-9b").reduced(dtype="float32")
    ref = JaxServeEngine(cfg, parallel=JaxParallelConfig(
        fsdp=False, attention_kernel="pallas"), offload_weights=True,
        tracer=JaxTracer(), slo=JaxSLOMonitor({"serve": 1e-9}))
    port = serve.ServeEngine(get_config("yi-9b").reduced(dtype="float32"),
                             device="cpu", offload_weights=True,
                             tracer=Tracer(), slo=SLOMonitor({"serve": 1e-9}))
    port.model.set_params(params_from_jax(
        jax.tree.map(np.asarray, ref.params_home), "cpu"))
    ref_out = ref.serve([JaxRequest(i, p, MAX_NEW)
                         for i, p in enumerate(_prompts())])
    port_out = port.serve([serve.Request(i, p, MAX_NEW)
                           for i, p in enumerate(_prompts())])
    return ref, port, ref_out, port_out


def test_offloaded_tokens_match_reference_offloaded_engine(offloaded):
    _, _, ref_out, port_out = offloaded
    assert [r.tokens for r in port_out] == [r.tokens for r in ref_out]
    assert all(len(r.tokens) == MAX_NEW for r in port_out)


def test_offloaded_and_hbm_tokens_equal_in_port(engines, offloaded):
    """The same weights give the same tokens whether they live on the
    device or in the host tier (the reference's engines agree too)."""
    from repro_torch.models.params import tree_map
    _, hbm, ref_hbm, port_hbm = engines
    _, _, ref_off, _ = offloaded
    off = serve.ServeEngine(get_config("yi-9b").reduced(dtype="float32"),
                            device="cpu", offload_weights=True)
    off.model.set_params(tree_map(torch.clone, hbm.params_home))
    got = off.serve([serve.Request(i, p, MAX_NEW)
                     for i, p in enumerate(_prompts())])
    assert [r.tokens for r in got] == [r.tokens for r in port_hbm]
    assert [r.tokens for r in ref_off] == [r.tokens for r in ref_hbm]


def test_offloaded_spans_and_slo_counts_match_reference(offloaded):
    ref, port, _, _ = offloaded

    def shape(tracer):
        return [(e.kind, e.name, e.track) for e in tracer.events]
    assert shape(port.tracer) == shape(ref.tracer)
    got, want = port.slo.report()["serve"], ref.slo.report()["serve"]
    for k in ("count", "violations", "alerts", "slo_s"):
        assert got[k] == want[k], k
    assert got["count"] == len(PROMPT_LENS) and \
        got["violations"] == len(PROMPT_LENS)
    assert port.slo.alerting("serve") == ref.slo.alerting("serve")


def test_offloaded_engine_fetches_the_tree_on_every_call(monkeypatch,
                                                          engines):
    """One whole-tree fetch per prefill and per decode step, from a home
    tree on the host; the HBM engine fetches nothing."""
    fetched = []
    fetch = serve.fetch_to_device

    def counting_fetch(tree, device):
        out = fetch(tree, device)
        fetched.append(sum(x.numel() for x in _leaves(out)))
        return out
    monkeypatch.setattr(serve, "fetch_to_device", counting_fetch)
    cfg = get_config("yi-9b").reduced(dtype="float32")
    engine = serve.ServeEngine(cfg, device="cpu", offload_weights=True)
    assert all(x.device.type == "cpu" for x in _leaves(engine.params_home))
    reqs = [serve.Request(i, p, MAX_NEW) for i, p in enumerate(_prompts())]
    engine.serve(reqs)
    assert len(fetched) == 1 + MAX_NEW
    assert set(fetched) == {engine.model.num_params}
    _, hbm, _, _ = engines
    fetched.clear()
    hbm.serve(reqs[:1])
    assert fetched == []


def _leaves(tree):
    from repro_torch.models.params import tree_flatten
    return [x for _, x in tree_flatten(tree)]


@pytest.mark.parametrize("order", [(0, 1, 2, 3, 4), (0, 2, 1, 3, 4),
                                   (4, 3, 2, 1, 0)])
def test_streaming_param_server_matches_reference(order):
    """Same layers in the same order, the same buffer after every get, the
    same values; in layer order never more than two layers buffered."""
    import jax.numpy as jnp
    from repro.core.offload import StreamingParamServer as JaxServer
    from repro_torch.core.offload import StreamingParamServer
    from repro_torch.models.params import tree_map
    rng = np.random.default_rng(1)
    host = {"w": rng.standard_normal((5, 3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal((5, 2)).astype(np.float32)}}
    ref = JaxServer(jax.tree.map(jnp.asarray, host), 5,
                    lambda t, i: jax.tree.map(lambda x: x[i], t))
    port = StreamingParamServer(
        tree_map(torch.from_numpy, host), 5,
        lambda t, i: tree_map(lambda x: x[i], t), device="cpu")
    for i in order:
        want, got = ref.get(i), port.get(i)
        np.testing.assert_array_equal(got["w"].numpy(),
                                      np.asarray(want["w"]))
        np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                      np.asarray(want["b"]["c"]))
        np.testing.assert_array_equal(got["w"].numpy(), host["w"][i])
        assert sorted(port._buf) == sorted(ref._buf)
        if list(order) == sorted(order):      # in layer order, as served
            assert len(port._buf) <= 2


def test_cli_offload_writes_observability_files(tmp_path, capsys):
    from repro_torch.obs import validate_chrome_trace
    paths = {k: tmp_path / f"{k}.out" for k in
             ("trace", "recorder", "openmetrics", "metrics")}
    serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                "--prompt", "12", "--gen", "3", "--offload-weights",
                "--trace-out", str(paths["trace"]),
                "--recorder-out", str(paths["recorder"]),
                "--recorder-capacity", "16",
                "--openmetrics-out", str(paths["openmetrics"]),
                "--metrics-out", str(paths["metrics"])])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["offloaded"] is True and len(report["sample"]) == 3
    trace = json.loads(paths["trace"].read_text())
    validate_chrome_trace(trace)
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "B"]
    assert names.count("serve.prefill") == 1
    assert names.count("serve.decode_step") == 3
    flight = json.loads(paths["recorder"].read_text())
    validate_chrome_trace(flight)
    assert flight["metadata"]["capacity"] == 16
    text = paths["openmetrics"].read_text()
    assert text.endswith("# EOF\n")
    assert "serve_decode_steps_total 3" in text
    assert json.loads(paths["metrics"].read_text())["counters"][
        "serve.requests"] == 2


def test_cli_metrics_listen_serves_the_snapshot(monkeypatch, capsys):
    """--metrics-listen serves until interrupted: the stand-in for the
    wait scrapes the endpoint once, then interrupts."""
    import urllib.request
    scraped = []

    def scrape_then_interrupt(_):
        note = capsys.readouterr().err.strip().splitlines()[-1]
        url = note.split()[2]
        with urllib.request.urlopen(url, timeout=30) as resp:
            scraped.append(resp.read().decode("utf-8"))
        raise KeyboardInterrupt
    monkeypatch.setattr(serve.time, "sleep", scrape_then_interrupt)
    serve.main(["--reduced", "--device", "cpu", "--requests", "1",
                "--prompt", "8", "--gen", "2", "--offload-weights",
                "--metrics-listen", "127.0.0.1:0"])
    assert len(scraped) == 1
    assert "serve_tokens_generated_total 2" in scraped[0]


def test_offloaded_engine_refuses_a_machine_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        serve.ServeEngine(get_config("yi-9b").reduced(),
                          offload_weights=True)


def test_failed_pin_raises_instead_of_keeping_weights_elsewhere(monkeypatch):
    """Placing weights in the host tier of a CUDA model pins them; if the
    runtime refuses, the placement raises (no unpinned or device copy is
    carried on)."""
    from repro_torch.core import offload

    class Refusing:
        def cudaHostRegister(self, ptr, nbytes, flags):
            return 2                                 # cudaErrorMemoryAllocation
    monkeypatch.setattr(torch.cuda, "cudart", lambda: Refusing())
    with pytest.raises(RuntimeError, match="cannot pin host memory"):
        offload.put_tree({"w": torch.ones(4, 4, dtype=torch.bfloat16)},
                         "pinned_host", "cuda")


# ---------------------------------------------------------------------------
# The scheduler options the pager's consumers read: deadlines, violations,
# the admitted plan, per-call QoS weight, attribution instants
# ---------------------------------------------------------------------------


def _sched_cache(pkg, kv_dtype=None):
    """qos_decode_admission's pager (bf16, 2:1), in either package."""
    if pkg == "ref":
        import jax.numpy as jnp
        from repro.serving.pager import PagedKVCache, PagerConfig
        kv, kw = jnp.zeros((544, 8, 128), jnp.bfloat16), {}
    else:
        from repro_torch.serving.pager import PagedKVCache, PagerConfig
        kv, kw = torch.zeros(544, 8, 128, dtype=torch.bfloat16), \
            {"device": "cpu"}
    c = PagedKVCache(PagerConfig(page_size=64, n_pages=64, kv_heads=8,
                                 head_dim=128, weights=(2, 1),
                                 kv_dtype=kv_dtype), **kw)
    for s in range(4):
        c.allocate(s)
        c.append(s, kv, kv)
    return c


def _schedule_json(ds) -> str:
    p = ds.plan
    return json.dumps({
        "steps": [list(s.__dict__.values()) for s in ds.steps],
        "admit": ds.admit_time, "finish": ds.finish_time,
        "makespan": ds.makespan, "sync": ds.sync_makespan,
        "prefetch": ds.prefetch_total, "violations": ds.violations,
        "plan": [p.order, p.eta, p.total_time, p.effective_bw,
                 p.transfer_plan.wire_bytes, p.transfer_plan.route.label]},
        sort_keys=True)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("kw", [{}, {"priority": 0}, {"priority": 1},
                                {"priority": 2}])
def test_decode_scheduler_deadlines_match_reference(kv_dtype, kw):
    from repro.fabric.contention import Flow as RefFlow
    from repro.launch.serve import DecodeScheduler as RefScheduler
    from repro_torch.fabric.contention import Flow
    out = {}
    for pkg, Sched, F, T in (("ref", RefScheduler, RefFlow, JaxTracer),
                             ("port", serve.DecodeScheduler, Flow, Tracer)):
        tr = T(clock=lambda: 0.0)
        bg = (F("bulk", "host", "hbm", nbytes=256 << 20),)
        sched = Sched(_sched_cache(pkg, kv_dtype), background=bg,
                      step_time=100e-6, tracer=tr, **kw)
        first = sched.schedule([0, 1, 2, 3], 16)
        # deadlines between the first and the last completion: some miss
        mid = sorted(first.finish_time.values())[1]
        ds = sched.schedule([0, 1, 2, 3], 16,
                            deadlines={s: mid for s in range(4)})
        out[pkg] = (_schedule_json(first), _schedule_json(ds),
                    [tuple(e) for e in tr.events],
                    json.dumps(tr.metrics.to_json(), sort_keys=True))
    assert out["port"] == out["ref"]
    ds = json.loads(out["port"][1])
    assert ds["violations"] and len(ds["violations"]) < 4
    names = {e[1] for e in out["port"][2]}
    assert {"attrib.request", "sched.deadline_miss"} <= names


@pytest.mark.parametrize("deadlines", [None, {0: 1e-5, 1: 1.0, 3: 2e-5}])
def test_admission_schedule_attribution_matches_reference(deadlines):
    """admission_schedule with seq_flows, starts and prefill_done (the
    disaggregated serve's arguments): the same schedule, the same
    ``attrib.request`` instants and metrics."""
    from repro.launch.serve import admission_schedule as ref_admit
    from repro.serving.pager import plan_prefetch as ref_plan
    from repro_torch.serving.pager import plan_prefetch
    ready = {0: 0.0, 1: 9e-6, 2: 2e-5, 3: 4e-5}
    args = dict(deadlines=deadlines,
                seq_flows={s: [f"page{p}" for p in (s, s + 4)]
                           for s in ready},
                starts={s: s * 1e-6 for s in ready},
                prefill_done={0: 2e-6, 2: 5e-6})
    out = {}
    for pkg, admit, plan, T in (("ref", ref_admit, ref_plan, JaxTracer),
                                ("port", serve.admission_schedule,
                                 plan_prefetch, Tracer)):
        tr = T(clock=lambda: 0.0)
        ds = admit(ready, plan(list(range(8)), 1 << 20), 3, 1e-5,
                   tracer=tr, **args)
        out[pkg] = (_schedule_json(ds), [tuple(e) for e in tr.events],
                    json.dumps(tr.metrics.to_json(), sort_keys=True))
    assert out["port"] == out["ref"]
    instants = [e for e in out["port"][1] if e[1] == "attrib.request"]
    assert len(instants) == 4 and "prefill_done" in instants[0][6]


@pytest.mark.parametrize("prefetch_priority", [0, 1])
def test_simulate_paged_decode_prefetch_priority_matches_reference(
        prefetch_priority):
    from repro.launch.serve import simulate_paged_decode as ref_sim
    got = serve.simulate_paged_decode(requests=3, gen=6,
                                      prefetch_priority=prefetch_priority,
                                      device="cpu")
    want = ref_sim(requests=3, gen=6, prefetch_priority=prefetch_priority)
    assert got == want


def test_cli_degrade_sim_matches_direct_runs(capsys):
    """``--degrade-sim`` prints the port's own reacting and baseline runs
    (the reference CLI cannot run its reacting arm under the installed
    jax: its pager's fetch raises)."""
    from repro_torch.runtime.degrade import (DegradedServeConfig,
                                             host_link_degraded,
                                             run_degraded_serve)
    serve.main(["--degrade-sim", "--degrade-factor", "0.4",
                "--degrade-round", "3", "--step-us", "80",
                "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    cfg = DegradedServeConfig(step_us=80.0)
    sched = host_link_degraded(at_round=3, factor=0.4)
    want = {"react": run_degraded_serve(sched, cfg=cfg, react=True,
                                        device="cpu").to_json(),
            "baseline": run_degraded_serve(sched, cfg=cfg, react=False,
                                           device="cpu").to_json()}
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(json.loads(json.dumps(want)), sort_keys=True)
    assert got["react"]["recovery_frac"] > got["baseline"]["recovery_frac"]


def test_cli_degrade_sim_writes_the_recorder_dump(tmp_path, capsys):
    out = tmp_path / "flight.json"
    serve.main(["--degrade-sim", "--device", "cpu", "--recorder-out",
                str(out), "--recorder-capacity", "256"])
    capsys.readouterr()
    trace = json.loads(out.read_text())
    assert trace["metadata"]["reason"].startswith(
        ("detector_fire", "slo_violation"))
