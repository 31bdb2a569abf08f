"""repro_torch.examples vs the reference's ``examples/``, on the CPU.

offload_tuning is pure cost model: its output must equal the reference's
byte for byte. The other three train or serve with randomly drawn weights,
and the reference's draw differs from process to process (its salted
``hash`` of parameter paths, ROADMAP C4), so only their deterministic lines
(the arch, the placement plan, the cost model, the config) are held against
the reference's; the rest is held to the examples' own invariants. The
reference's scripts are loaded from their files; where a line comes before
a training run, the reference is stopped there (its ``train`` replaced by
a stub that raises) instead of being run to the end.
"""

import dataclasses
import importlib.util
import json
import math
import pathlib
import sys
import tempfile
import types

import pytest
import torch
from config_view import same_config

ROOT = pathlib.Path(__file__).resolve().parents[1]


class Stop(Exception):
    """Raised by a stub to end a reference example early."""


def _reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name: str):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _stop(*args, **kwargs):
    raise Stop


def _ref_stdout(name, monkeypatch, capsys, args=(), **stubs) -> str:
    mod = _reference(name)
    for attr, stub in stubs.items():
        monkeypatch.setattr(mod, attr, stub)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    try:
        mod.main()
    except Stop:
        pass
    return capsys.readouterr().out


@pytest.mark.parametrize("args", [
    [], ["--model-gib", "17.66", "--hbm-gib", "79.2", "--link-gbs", "54.9",
         "--peak-tflops", "989", "--kv-mib-per-seq", "64",
         "--max-concurrency", "64"]], ids=["defaults", "other-flags"])
def test_offload_tuning_prints_the_reference_output(monkeypatch, capsys,
                                                    args):
    want = _ref_stdout("offload_tuning", monkeypatch, capsys, args)
    _port("offload_tuning").main(args)
    got = capsys.readouterr().out
    assert got == want
    assert "paper-faithful optimum" in got


def test_quickstart_on_the_cpu(monkeypatch, capsys, tmp_path):
    want = _ref_stdout("quickstart", monkeypatch, capsys, train=_stop)
    # the example's checkpoint directory lives in the temporary directory
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = _port("quickstart").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    head = [ln for ln in got if ln.startswith(
        ("arch=", "placement:", "cost-model optimal offload:"))]
    assert head == want.splitlines() and len(head) == 3
    hist = out["train"]["history"]
    assert len(hist) == 10 and all(math.isfinite(x) for x in hist)
    vocab = out["engine"].cfg.vocab_size
    for r in out["results"]:
        assert len(r.tokens) == 8
        assert all(0 <= t < vocab for t in r.tokens)
    assert got[-1].startswith("serve: ")


def test_serve_batched_on_the_cpu(monkeypatch, capsys):
    """The reference's JSON keys (its engine replaced by a stub that
    answers at once), positive values from the port's two engines."""
    class Engine:
        def __init__(self, cfg, offload_weights=False):
            pass

        def serve(self, reqs):
            return [types.SimpleNamespace(tokens=[0] * r.max_new,
                                          prefill_ms=1.0,
                                          decode_ms_per_tok=1.0)
                    for r in reqs]
    out_ref = _ref_stdout("serve_batched", monkeypatch, capsys,
                          ServeEngine=Engine)
    want = json.loads(out_ref[:out_ref.rindex("}") + 1])
    out = _port("serve_batched").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert json.loads(text[:text.rindex("}") + 1]) == out
    assert list(out) == list(want)
    for arm in want:
        assert list(out[arm]) == list(want[arm])
        assert all(v > 0 for v in out[arm].values()), out


def test_train_tiny_lm_on_the_cpu(monkeypatch, capsys, tmp_path):
    args = ["--tiny", "--steps", "4"]
    want = _ref_stdout("train_tiny_lm", monkeypatch, capsys, args,
                       train=_stop)
    out = _port("train_tiny_lm").main(
        args + ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want.strip() == \
        "lm-100m: ~0M params, 4 steps @ batch=4 seq=64"
    hist = out["history"]
    assert len(hist) == 4 and all(math.isfinite(x) for x in hist)
    last = json.loads(got[-1])
    assert sorted(last) == ["final_loss", "first_loss", "improved"]
    assert last["improved"] == (hist[-1] < hist[0])


def test_lm_100m_is_the_reference_config():
    want = _reference("train_tiny_lm").lm_100m()
    got = _port("train_tiny_lm").lm_100m()
    assert same_config(got, want) == dataclasses.asdict(want)
    assert got.num_params == want.num_params
    assert same_config(got.reduced(), want.reduced()) == \
        dataclasses.asdict(want.reduced())


@pytest.mark.parametrize("name,args", [
    ("quickstart", []), ("serve_batched", []),
    ("train_tiny_lm", ["--tiny", "--steps", "1"])])
def test_examples_refuse_a_machine_without_cuda(monkeypatch, capsys,
                                                tmp_path, name, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        _port(name).main(args)
    assert capsys.readouterr().out == ""
    assert not list(tmp_path.iterdir())
