"""repro_torch.heimdall.run (HEIMDALL's benchmark runner) vs the reference's
``benchmarks/run.py``, on the CPU.

The reference's runner is a script, not a package module: it is loaded
from its file and driven through ``sys.argv``; the port's takes ``argv``
and ``--device cpu``. Both must print the same CSV rows and stderr family
lines, write the same ``BENCH_<family>.json`` and exit with the same code
and message. Only families that fault C1 (ROADMAP) leaves runnable on the
reference side are driven here; the obs and resilience summaries are held
in ``test_torch_heimdall_obs.py`` and ``test_torch_families.py``.
"""

import importlib.util
import inspect
import json
import pathlib
import sys

import pytest
import torch

from test_torch_heimdall import _shape

from repro_torch.heimdall import run as port

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "reference_benchmarks_run", ROOT / "benchmarks" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _exit_code(e: SystemExit):
    return 0 if e.code is None else e.code


def _run_ref(ref, monkeypatch, capsys, args: list) -> tuple:
    """(exit code or message, stdout, stderr lines without tracebacks)."""
    monkeypatch.setattr(sys, "argv", ["run.py", *args])
    code = 0
    try:
        ref.main()
    except SystemExit as e:
        code = _exit_code(e)
    cap = capsys.readouterr()
    return code, cap.out, _status(cap.err)


def _run_port(capsys, args: list) -> tuple:
    code = 0
    try:
        port.main([*args, "--device", "cpu"])
    except SystemExit as e:
        code = _exit_code(e)
    cap = capsys.readouterr()
    return code, cap.out, _status(cap.err)


def _status(err: str) -> list:
    """The runner's own stderr lines (family status, wrote, summary
    failures), with the paths they name reduced to file names."""
    keep = ("family ", "wrote ", "summary for ", "failed summaries")
    return [ln.rsplit("/", 1)[-1] if ln.startswith("wrote ") else ln
            for ln in err.splitlines() if ln.startswith(keep)]


def _no_reruns(row: str) -> str:
    """``row`` without the ``;n_reruns=N`` that ``Row.csv`` adds only when
    the noise guard remeasured (a timing on a loaded host may, on either
    side); N, where present, is 1 or 2 (``time_fn_stats``' max_reruns)."""
    head, sep, n = row.rpartition(";n_reruns=")
    if not sep:
        return row
    assert n in ("1", "2"), row
    return head


def test_family_tables_match_reference(ref):
    want, got = ref._families(), port._families()
    assert list(got) == list(want)
    for fam in want:
        # the reference's JAX probe is the port's torch probe (by design)
        assert [f.__name__ for f in got[fam]] == \
            [f.__name__.replace("_jax_", "_torch_") for f in want[fam]], fam
    assert port.SUMMARIZABLE == ref.SUMMARIZABLE


def test_simulated_table_matches_signatures():
    """A bench or summary takes ``device`` exactly when SIMULATED leaves
    it out."""
    fns = [f for fams in port._families().values() for f in fams]
    fns += [port._summary_fn(f) for f in port.SUMMARIZABLE]
    for fn in fns:
        takes = "device" in inspect.signature(fn).parameters
        assert takes == (fn.__name__ not in port.SIMULATED), fn.__name__
    names = {f.__name__ for f in fns}
    assert port.SIMULATED <= names


def test_simulated_families_match_reference(ref, monkeypatch, capsys):
    args = ["--families", "qos,interference"]
    want = _run_ref(ref, monkeypatch, capsys, args)
    got = _run_port(capsys, args)
    assert want[0] == 0
    assert got == want
    assert got[1].count("\n") == 1 + 40


def test_kv_quant_family_and_json_match_reference(ref, monkeypatch, capsys,
                                                  tmp_path):
    """The same rows (the kernel wall rows, measured, by name and keys;
    the port's first one also names the device), the same status lines
    and the same BENCH_kv_quant.json."""
    a, b = tmp_path / "ref.json", tmp_path / "port.json"
    want = _run_ref(ref, monkeypatch, capsys,
                    ["--families", "kv_quant", "--json-out", str(a)])
    got = _run_port(capsys, ["--families", "kv_quant", "--json-out", str(b)])
    assert got[0] == want[0] == 0
    assert [ln.replace(b.name, a.name) for ln in got[2]] == want[2]
    rows_w, rows_g = want[1].splitlines(), got[1].splitlines()
    assert len(rows_g) == len(rows_w) == 1 + 11
    for w, g in zip(rows_w, rows_g):
        if w.startswith("kv_quant_kernel/"):
            g = g.replace(";device=cpu", "")
            assert _shape(_no_reruns(g)) == _shape(_no_reruns(w))
        else:
            assert g == w
    assert json.loads(b.read_text()) == json.loads(a.read_text())


@pytest.mark.parametrize("args", [
    ["--families", "qos,kv_quant", "--json-out", "x.json"],
    ["--families", "interference", "--json-out-dir", "out"],
    ["--families", "qos,nope"],
    ["--only", "nomatch"],
], ids=["json-out-two-families", "json-out-dir-none", "unknown-family",
        "only-nomatch"])
def test_arguments_match_reference(ref, monkeypatch, capsys, tmp_path, args):
    monkeypatch.chdir(tmp_path)
    want = _run_ref(ref, monkeypatch, capsys, args)
    got = _run_port(capsys, args)
    assert got == want
    if args[0] == "--only":
        assert got[0] == 0 and got[1] == "name,us_per_call,derived\n"
    else:
        assert isinstance(got[0], str) and got[1] == ""
    assert not list(tmp_path.iterdir())


def test_a_failing_summary_fails_the_run_but_not_the_others(
        ref, monkeypatch, capsys, tmp_path):
    from repro.heimdall import qos as ref_qos

    from repro_torch.heimdall import qos

    def broken():
        raise ValueError("broken summary")
    broken.__name__ = "qos_summary"
    monkeypatch.setattr(qos, "qos_summary", broken)
    monkeypatch.setattr(ref_qos, "qos_summary", broken)
    args = ["--families", "qos,kv_quant", "--only", "nomatch"]
    want = _run_ref(ref, monkeypatch, capsys,
                    args + ["--json-out-dir", str(tmp_path / "ref")])
    got = _run_port(capsys, args + ["--json-out-dir",
                                    str(tmp_path / "port")])
    assert got == want
    assert got[0] == 1
    assert "summary for qos FAILED: ValueError: broken summary" in got[2]
    assert got[2][-1] == "failed summaries: qos"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        ["BENCH_kv_quant.json"]
    assert (tmp_path / "port" / "BENCH_kv_quant.json").read_text() == \
        (tmp_path / "ref" / "BENCH_kv_quant.json").read_text()


def test_runner_without_a_card_raises_before_any_row(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args in ([], ["--families", "qos"], ["--only", "nomatch"]):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            port.main(args)
        cap = capsys.readouterr()
        assert cap.out == "" and "family" not in cap.err
