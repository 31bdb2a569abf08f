"""What the benchmark may import: no jax, jaxlib, flax or the JAX package
(``repro``) anywhere under ``perfbench/``, and nothing of the program
(``repro_torch``) in ``perfbench/reference/``. Names are compared whole by
their top-level part: ``repro_torch`` begins with ``repro`` and is not it."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from perfbench import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = _imported_tops(path) & set(run.FORBIDDEN)
    assert not bad, (path, bad)
    if "reference" in path.relative_to(HERE).parts:
        assert "repro_torch" not in _imported_tops(path), path


def _blocked(names, body: str) -> subprocess.CompletedProcess:
    script = "import sys\n" + "".join(
        f"sys.modules[{n!r}] = None\n" for n in names) + \
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n" + \
        textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120)


def test_the_harness_and_the_program_load_no_forbidden_module():
    proc = _blocked(run.FORBIDDEN, """
        import json
        from perfbench import run, control, split, trace, arith, traffic
        from perfbench.reference import check, engine, model, weights
        import repro_torch.launch.serve, repro_torch.obs
        for p in sorted((run.HERE / "metrics").glob("*.py")):
            run.reader(p.stem)
        for w in json.loads((run.ROOT / "BENCHMARK.json").read_text())[
                "workloads"]:
            cell = run.load_cell(w["name"])
            cell.family.port_config(cell.config)
            cell.family.yardstick(cell.config)
        assert run.forbidden_modules() == [], run.forbidden_modules()
        print("ok")
    """)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_the_reference_loads_without_the_program():
    proc = _blocked(run.FORBIDDEN + ("repro_torch",), """
        from perfbench.reference import check, engine, model, weights
        print("ok")
    """)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_forbidden_names_are_compared_whole():
    mods = {name: object() for name in ("repro_torch", "repro_torch.launch",
                                        "reprox", "jaxtyping", "flaxen")}
    assert run.forbidden_modules(mods) == []
    mods.update({"repro.core": object(), "jax": object(), "jaxlib": None})
    assert run.forbidden_modules(mods) == ["jax", "repro"]


def _mains(monkeypatch):
    """Each main that prints a result, with the card and the run stubbed
    out: (name, call)."""
    import torch
    from perfbench import control, split
    monkeypatch.setattr(run, "cache_env", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda: "card")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(run, "power_limit", lambda: None)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {
        "correct": True, "checks": {"gap": {"value": 0.0, "limit": 1.0}}})
    monkeypatch.setattr(control, "readings",
                        lambda *a, **k: iter([{"seed": 1}]))
    monkeypatch.setattr(split, "run_seeds", lambda *a, **k: [{"seed": 1}])
    cell = "yi9b-flexgen-hbm"
    return {
        "run": lambda: run.main(["--workload", cell, "--seed", "1",
                                 "--seconds", "1"]),
        "control.run": lambda: control.main(
            ["--workload", cell, "--seeds", "1", "--run", "control"]),
        "control.readings": lambda: control.main(
            ["--workload", cell, "--seeds", "1"]),
        "split": lambda: split.main(["--workload", cell, "--seeds", "1"]),
    }


@pytest.mark.parametrize("main", ["run", "control.run", "control.readings",
                                  "split"])
@pytest.mark.parametrize("holds_jax", [False, True])
def test_a_main_prints_no_result_in_a_process_that_holds_jax(
        monkeypatch, capsys, main, holds_jax):
    call = _mains(monkeypatch)[main]
    if holds_jax:
        monkeypatch.setitem(sys.modules, "jax", object())
    else:
        for name in list(sys.modules):
            if name.split(".")[0] in run.FORBIDDEN:
                monkeypatch.delitem(sys.modules, name)
    rc = call()
    out, err = capsys.readouterr()
    if holds_jax:
        assert rc == 3 and out == "", out
        assert "['jax']" in err, err
    else:
        assert rc == 0 and out.strip(), err
