"""repro_torch.serving.disagg vs the reference's, on the CPU.

Disaggregated prefill/decode is a simulation on a fabric preset: its
report depends on roles, routes, page counts and the fabric, never on page
values, so the port must give the reference's report exactly (the same
JSON text, floats compared with ``==``), with its trace events and metrics.
The port's decode-node pager holds its pools on ``device="cpu"``.
"""

import dataclasses
import json
import sys

import pytest
import torch

PRESETS = ["dual_socket_cxl", "cxl_pool", "gh200", "mi300a", "tpu_v5e"]


def text(x) -> str:
    return json.dumps(x, sort_keys=True, default=str)


def _sides():
    import repro.fabric.contention as rc
    import repro.fabric.systems as rs
    import repro.obs as ro
    import repro.serving.disagg as rd
    import repro_torch.fabric.contention as pc
    import repro_torch.fabric.systems as ps
    import repro_torch.obs as po
    import repro_torch.serving.disagg as pd
    return ({"sys": rs, "flow": rc.Flow, "obs": ro, "dis": rd, "kw": {}},
            {"sys": ps, "flow": pc.Flow, "obs": po, "dis": pd,
             "kw": {"device": "cpu"}})


def same(fn):
    want, got = (fn(s) for s in _sides())
    assert text(got) == text(want)
    return got


def _choice(c) -> dict:
    return {"staging": c.staging, "est_time": c.est_time,
            "considered": c.considered, "route": c.route.label,
            "leg1": c.leg1.label if c.leg1 is not None else None,
            "bottleneck": c.route.bottleneck_bw,
            "latency": c.route.latency,
            "provenance": c.route.provenance}


def _roles_or_error(s, system, **kw):
    try:
        return dataclasses.asdict(s["dis"].default_roles(system, **kw))
    except ValueError as e:
        return {"error": str(e)}


@pytest.mark.parametrize("name", PRESETS)
def test_default_roles_match_reference(name):
    def go(s):
        system = s["sys"].get_system(name)
        out = {"default": _roles_or_error(s, system)}
        nodes = system.compute_nodes()
        for c in nodes:
            out[f"decode={c}"] = _roles_or_error(s, system, decode=c)
            out[f"prefill={c}"] = _roles_or_error(s, system, prefill=c)
        out["bad_decode"] = _roles_or_error(s, system, decode="nope")
        out["bad_prefill"] = _roles_or_error(s, system, prefill="nope")
        return out
    got = same(go)
    assert "error" in got["bad_decode"] and "error" in got["bad_prefill"]


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("kw", [{}, {"priority": 1, "weight": 2.0}])
def test_choose_ship_route_matches_reference(name, kw):
    def go(s):
        system = s["sys"].get_system(name)
        out = {}
        for c in system.compute_nodes():
            roles = _roles_or_error(s, system, prefill=c)
            if "error" in roles:
                continue
            roles = s["dis"].DisaggRoles(**roles)
            mem = roles.prefill_mem
            bg = (s["flow"]("bulk", mem, roles.decode, nbytes=64 << 20),)
            for label, b in (("quiet", ()), ("loaded", bg)):
                out[f"{c}/{label}"] = _choice(s["dis"].choose_ship_route(
                    system, roles, 32 << 20, background=b, **kw))
        return out
    same(go)


def _degraded_ici(s):
    sys_ = s["sys"].get_system("tpu_v5e")
    return dataclasses.replace(
        sys_, fabric=sys_.fabric.rescaled({("chip0", "chip1"): (0.001, 1.0)},
                                          name="tpu_v5e+ici_degraded"))


def _run(s, variant, kv_dtype, tracer=None, **kw):
    cfg = dict(requests=6, prompt=512, gen=12, kv_dtype=kv_dtype)
    system = None
    if variant == "contended":
        cfg["background"] = (s["flow"]("co_tenant", "pool_mem", "host0"),)
    elif variant == "egalitarian":
        cfg["background"] = (s["flow"]("co_tenant", "pool_mem", "host0"),)
        cfg["ship_priority"] = 0
    elif variant == "degraded_ici":
        cfg["system"] = "tpu_v5e"
        system = _degraded_ici(s)
    if tracer is not None:
        kw["tracer"] = tracer
    return s["dis"].run_disagg_serve(s["dis"].DisaggConfig(**cfg),
                                     system=system, **kw, **s["kw"])


@pytest.mark.parametrize("variant", ["quiet", "contended", "egalitarian",
                                     "degraded_ici"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_disagg_serve_traced_matches_reference(variant, kv_dtype):
    def go(s):
        tr = s["obs"].Tracer(clock=lambda: 0.0)
        rep = _run(s, variant, kv_dtype, tracer=tr)
        return {"report": rep.to_json(), "overlap": rep.overlap_speedup,
                "choice": _choice(rep.choice),
                "events": [tuple(e) for e in tr.events],
                "metrics": tr.metrics.to_json()}
    got = same(go)
    rep = got["report"]
    assert {"attribution", "slo", "telemetry"} <= set(rep)
    if variant == "degraded_ici":
        assert rep["route"]["staging"] is not None


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_disagg_serve_quiet_and_with_slo_match_reference(kv_dtype):
    def go(s):
        plain = _run(s, "contended", kv_dtype)
        slo = s["obs"].SLOMonitor()
        with_slo = _run(s, "contended", kv_dtype, slo=slo)
        return {"plain": plain.to_json(), "slo": with_slo.to_json(),
                "monitor": slo.report()}
    got = same(go)
    assert "attribution" not in got["plain"] and "slo" in got["slo"]


def test_disagg_serve_calibration_profile_raises():
    """A profile fitted on another preset has no route on the serve's, as
    in the reference; calibrated serves are held against the reference in
    tests/test_torch_calibrate.py."""
    import repro.calibrate as rc
    import repro_torch.calibrate as pc
    from repro.serving.disagg import DisaggConfig as RC
    from repro.serving.disagg import run_disagg_serve as ref_run
    from repro_torch.serving.disagg import DisaggConfig, run_disagg_serve
    with pytest.raises(ValueError) as want:
        ref_run(RC(requests=1), calibration_profile=rc.CalibrationRunner(
            "tpu_v5e").calibrate())
    with pytest.raises(ValueError) as got:
        run_disagg_serve(DisaggConfig(requests=1),
                         calibration_profile=pc.CalibrationRunner(
                             "tpu_v5e").calibrate(), device="cpu")
    assert str(got.value) == str(want.value)
    assert "has no route in preset 'cxl_pool'" in str(got.value)


def test_disagg_serve_refuses_a_machine_without_cuda(monkeypatch):
    from repro_torch.serving.disagg import DisaggConfig, run_disagg_serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        run_disagg_serve(DisaggConfig(requests=1))


@pytest.mark.parametrize("args", [[], ["--kv-dtype", "int8"],
                                  ["--system", "tpu_v5e", "--requests", "3"]])
def test_cli_disagg_sim_matches_reference_cli(monkeypatch, capsys, args):
    """``--disagg-sim`` prints the reference CLI's JSON, byte for byte."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch.serve import main
    monkeypatch.setattr(sys, "argv", ["serve", "--disagg-sim", *args])
    ref_serve.main()
    want = capsys.readouterr().out
    main(["--disagg-sim", *args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["overlap_speedup"] > 0
