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
