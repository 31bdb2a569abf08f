"""repro_torch ServeEngine vs the reference's, on reduced yi-9b.

The reference engine runs the Pallas flash kernel in interpret mode
(``attention_kernel="pallas"``); the port's runs its ``"kernel"`` path,
which on CPU tensors is the kernel's plain version. Both cast their weights
to bf16; fp32 activations keep argmax ties away, so the generated tokens
must be identical.
"""

import json

import jax
import numpy as np
import pytest

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


def test_weight_offload_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="slice 4a"):
        serve.ServeEngine(get_config("yi-9b").reduced(), device="cpu",
                          offload_weights=True)
