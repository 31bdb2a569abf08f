"""repro_torch stands alone: no jax, no repro, and no silent move to the CPU."""

import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def test_port_imports_neither_jax_nor_repro():
    script = textwrap.dedent(f"""
        import pkgutil, sys
        sys.path.insert(0, {str(SRC)!r})
        sys.modules["jax"] = None          # any `import jax` now raises
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            __import__(name)
        leaked = sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20   # every module was imported


def test_engine_without_device_refuses_a_machine_without_cuda(monkeypatch):
    from repro_torch.config.base import get_config
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models.model import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("yi-9b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        Model.create(cfg, device="cuda")


def test_pager_entry_points_refuse_a_machine_without_cuda(monkeypatch):
    from repro_torch.heimdall.kv_quant import kv_quant_kernel_wall
    from repro_torch.launch.serve import (paired_kv_caches,
                                          simulate_paged_decode)
    from repro_torch.serving.pager import PagedKVCache, PagerConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: PagedKVCache(PagerConfig()),
                 lambda: paired_kv_caches(requests=1, tokens=8),
                 lambda: simulate_paged_decode(requests=1, gen=1),
                 lambda: kv_quant_kernel_wall()):
        with pytest.raises(RuntimeError,
                           match="no CUDA device is available"):
            call()
