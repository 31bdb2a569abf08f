"""repro_torch stands alone: no jax, no repro, no ml_dtypes, and no silent
move to the CPU."""

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
        sys.modules["ml_dtypes"] = None    # comes with jax; absent on a card
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            __import__(name)
        leaked = sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro.")
                        or (m.split(".")[0] in ("jax", "ml_dtypes")
                            and sys.modules[m] is not None))
        assert not leaked, leaked
        for name in ("calibrate.fit", "calibrate.profile", "calibrate.recal",
                     "calibrate.runner", "calibrate.validate",
                     "heimdall.micro", "heimdall.apps",
                     "heimdall.calibration", "heimdall.obs",
                     "kernels.probes.ops", "kernels.probes.ref"):
            assert "repro_torch." + name in names, name
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 40   # every module was imported


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


def test_pager_consumers_refuse_a_machine_without_cuda(monkeypatch):
    from repro_torch.heimdall import disagg, qos, resilience
    from repro_torch.launch.serve import main
    from repro_torch.runtime import host_link_degraded, run_degraded_serve
    from repro_torch.serving.disagg import DisaggConfig, run_disagg_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: run_degraded_serve(host_link_degraded()),
                 lambda: run_disagg_serve(DisaggConfig(requests=1)),
                 lambda: qos.qos_decode_admission(),
                 lambda: disagg.disagg_summary(),
                 lambda: resilience.resilience_summary(),
                 lambda: main(["--degrade-sim"]),
                 lambda: main(["--disagg-sim", "--requests", "1"])):
        with pytest.raises(RuntimeError,
                           match="no CUDA device is available"):
            call()


def test_train_refuses_a_machine_without_cuda(monkeypatch, tmp_path):
    from repro_torch.config.base import RunConfig, ShapeConfig, get_config
    from repro_torch.data.synthetic import PrefetchLoader
    from repro_torch.launch import train as train_mod
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("yi-9b").reduced()
    shape = ShapeConfig("t", 8, 2, "train")
    run = RunConfig(steps=1, checkpoint_dir=str(tmp_path))
    for call in (lambda: train_mod.train(cfg, shape, run),
                 lambda: PrefetchLoader(cfg, shape),
                 lambda: train_mod.main(["--reduced", "--steps", "1",
                                         "--ckpt-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError,
                           match="no CUDA device is available"):
            call()


def test_train_cli_runs_on_the_cpu_when_asked(tmp_path, capsys):
    import json
    from repro_torch.launch.train import main
    main(["--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
          "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_loss"] > 0


def test_measurement_entry_points_refuse_a_machine_without_cuda(monkeypatch):
    from repro_torch.calibrate import CalibrationRunner
    from repro_torch.heimdall import apps, calibration, micro, obs
    from repro_torch.kernels.probes import pointer_chase
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: micro.micro_latency(),
                 lambda: apps.app_kv_workload(),
                 lambda: calibration.calibration_torch_probe(),
                 lambda: obs.obs_attribution(),
                 lambda: CalibrationRunner(source="torch").calibrate()):
        with pytest.raises(RuntimeError,
                           match="no CUDA device is available"):
            call()
    # a probe asked to run on a card that is not there never falls back
    with pytest.raises((RuntimeError, AssertionError)):
        pointer_chase(torch.arange(4, dtype=torch.int32), 2, device="cuda")
