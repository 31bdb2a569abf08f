"""repro_torch.calibrate and the calibrated paths vs the reference's, on the
CPU.

The emulated source draws its noise from ``random.Random(seed)`` in the
reference's order, so its samples, the fit, the calibrated systems, the
validation reports and the recalibrations must equal the reference's as
JSON text (floats compared with ``==``). Profiles carry machine metadata,
which differs by design (the port records PyTorch and CUDA, the reference
JAX and its backend): the comparisons fit with ``machine={}`` on both sides
or drop that one field. The real source (``"torch"``) times copies; on the
CPU it runs with ``device="cpu"`` and its times are only checked for shape.

The reference's recovery cannot fetch spilled pages under the installed
jax (ROADMAP fault C1), so the recalibrating degraded serve runs it through
``test_torch_degrade.patch_reference_fetch``.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from test_torch_degrade import patch_reference_fetch

import repro.calibrate as R
import repro_torch.calibrate as T

SYSTEMS = ["tpu_v5e", "dual_socket_cxl", "cxl_pool", "gh200"]


def text(x) -> str:
    return json.dumps(x, sort_keys=True, default=_plain)


def _plain(x):
    if hasattr(x, "to_json"):
        return x.to_json()
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    raise TypeError(f"cannot compare {type(x).__name__}")


def _profile(m, system="tpu_v5e", **kw):
    runner = m.CalibrationRunner(system, **kw)
    return runner, m.fit_profile(runner.run(), runner.system, machine={})


def _fabric(system) -> list:
    return sorted((a, b, link.type.value, link.bandwidth, link.latency)
                  for (a, b), link in system.fabric.links.items())


# ---------------------------------------------------------------------------
# runner, fit, profile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("system", SYSTEMS)
def test_emulated_samples_and_fit_match_reference(system):
    want = _profile(R, system)[1]
    got = _profile(T, system)[1]
    assert text(got) == text(want)
    assert got.source == "emulated" and len(got.links) >= 1


@pytest.mark.parametrize("kw", [
    dict(truth_kw=dict(noise=0.3, seed=3), max_dispersion=0.05),
    dict(truth_kw=dict(efficiency={"pcie": 0.5}, latency_scale=2.0),
         sizes=(4096, 1 << 20), repeats=2, iters=4),
])
def test_runner_options_match_reference(kw):
    """Noisy samples (reruns, down-weighting) and other ladders."""
    kw = dict(kw)
    truth_kw = kw.pop("truth_kw")
    sides = []
    for m in (R, T):
        runner = m.CalibrationRunner("tpu_v5e", truth=m.TruthConfig(
            **truth_kw), **kw)
        sides.append(m.fit_profile(runner.run(), runner.system,
                                   max_dispersion=runner.max_dispersion,
                                   machine={}))
    assert text(sides[1]) == text(sides[0])
    assert any(s.reruns for s in sides[1].samples) or \
        "noise" not in truth_kw


def test_calibrate_matches_reference_but_for_machine():
    want = R.CalibrationRunner("gh200").calibrate().to_json()
    got = T.CalibrationRunner("gh200").calibrate().to_json()
    assert set(want.pop("machine")) >= {"jax", "backend"}
    machine = got.pop("machine")
    assert machine["torch"] == torch.__version__ and "jax" not in machine
    assert text(got) == text(want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_route_and_weights_match_reference(seed):
    """Random (nbytes, seconds, dispersion) samples straight into the
    fitter: weights, the weighted line, the trimmed fit."""
    rng = np.random.default_rng(seed)
    n = 9
    sizes = rng.choice([1 << 12, 1 << 16, 1 << 20, 1 << 24], n)
    secs = sizes / 20e9 + 3e-6
    secs = secs * np.exp(rng.normal(0, 0.05, n))
    secs[rng.integers(n)] *= 4.0                  # one wild sample
    disp = np.abs(rng.normal(0, 0.08, n))
    out = []
    for m in (R, T):
        samples = [m.LinkSample("tpu_v5e", "host_dram", "chip0", "pcie",
                                int(b), float(s), float(d))
                   for b, s, d in zip(sizes, secs, disp)]
        fit = sys.modules[f"{m.__name__}.fit"]
        out.append((
            [m.sample_weight(float(d)) for d in disp],
            fit._wls_line([float(x) for x in sizes], [float(y)
                                                      for y in secs],
                          [1.0 + float(d) for d in disp]),
            m.fit_route(samples, nominal_bandwidth=8e9,
                        nominal_latency=2e-6)))
    assert text(out[1]) == text(out[0])


def test_fit_degenerate_and_errors_match_reference():
    for m in (R, T):
        assert m.sample_weight(float("nan")) == 0.0
    msgs = []
    for m in (R, T):
        same_size = [m.LinkSample("tpu_v5e", "host_dram", "chip0", "pcie",
                                  4096, t, 0.0) for t in (2e-6, 1e-6)]
        est = m.fit_route(same_size, nominal_bandwidth=8e9,
                          nominal_latency=1e-6)
        got = [text(est)]
        for bad in ([], same_size + [dataclasses.replace(
                same_size[0], src="hbm0")]):
            with pytest.raises(ValueError) as e:
                m.fit_route(bad, nominal_bandwidth=8e9,
                            nominal_latency=1e-6)
            got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            m.fit_profile(same_size + [dataclasses.replace(
                same_size[0], system="gh200")])
        got.append(str(e.value))
        msgs.append(got)
    assert msgs[1] == msgs[0]


def test_profiles_load_across_packages(tmp_path):
    """A profile written by the reference loads in the port, and the
    other way round, to the same record."""
    _, ref_prof = _profile(R, "cxl_pool")
    _, port_prof = _profile(T, "cxl_pool")
    ref_prof.save(str(tmp_path / "ref.json"))
    port_prof.save(str(tmp_path / "port.json"))
    assert (tmp_path / "ref.json").read_text() == \
        (tmp_path / "port.json").read_text()
    from_ref = T.CalibrationProfile.load(str(tmp_path / "ref.json"))
    from_port = R.CalibrationProfile.load(str(tmp_path / "port.json"))
    assert text(from_ref) == text(port_prof)
    assert text(from_port) == text(ref_prof)
    assert text(from_ref.tier_measurements()) == \
        text(ref_prof.tier_measurements())
    from repro_torch.calibrate.profile import load_profile
    assert load_profile(str(tmp_path / "ref.json")).to_json() == \
        from_ref.to_json()
    assert load_profile(from_ref) is from_ref


def _mutations(data):
    yield "not an object", []
    yield "newer version", {**data, "version": 99}
    yield "no links", {k: v for k, v in data.items() if k != "links"}
    yield "bad samples", {**data, "samples": {}}
    bad = json.loads(json.dumps(data))
    bad["links"][1]["bandwidth"] = "fast"
    yield "mistyped link", bad
    bad = json.loads(json.dumps(data))
    del bad["samples"][2]["nbytes"]
    yield "sample missing a field", bad
    bad = json.loads(json.dumps(data))
    bad["links"][0]["future_field"] = 1
    bad["extra"] = {"x": 1}
    yield "unknown fields (tolerated)", bad


@pytest.mark.parametrize("case", [
    "not an object", "newer version", "no links", "bad samples",
    "mistyped link", "sample missing a field", "unknown fields (tolerated)"])
def test_profile_loader_matches_reference(case):
    data = _profile(R, "tpu_v5e")[1].to_json()
    bad = dict(_mutations(data))[case]
    out = []
    for m in (R, T):
        try:
            out.append(("ok", text(m.CalibrationProfile.from_json(bad))))
        except m.ProfileError as e:
            out.append(("ProfileError", str(e)))
    assert out[1] == out[0]


def test_profile_load_rejects_bad_json_as_reference(tmp_path):
    path = tmp_path / "broken.json"
    path.write_text("{not json")
    msgs = []
    for m in (R, T):
        with pytest.raises(m.ProfileError) as e:
            m.CalibrationProfile.load(str(path))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_machine_metadata_records_torch_not_jax(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = T.machine_metadata()
    assert meta["torch"] == torch.__version__
    assert meta["cuda"] == torch.version.cuda
    assert "jax" not in meta and "device" not in meta
    assert {"platform", "python", "machine"} <= set(meta)


# ---------------------------------------------------------------------------
# the real source
# ---------------------------------------------------------------------------


def test_torch_source_times_copies_of_the_addressable_tiers():
    runner = T.CalibrationRunner("tpu_v5e", source="torch",
                                 sizes=(1 << 12, 1 << 16), repeats=1,
                                 iters=3, device="cpu")
    samples = runner.run()
    by_tier = {}
    for tier, src, _ in runner.routes():
        by_tier[tier] = {s.source for s in samples if s.src == src}
    assert by_tier["hbm"] == {"torch"} and by_tier["host"] == {"torch"}
    assert all(v == {"emulated"} for t, v in by_tier.items()
               if t not in ("hbm", "host"))
    assert all(s.seconds > 0 and s.dispersion >= 0 for s in samples)
    prof = T.fit_profile(samples, runner.system)
    assert prof.source == "mixed" and len(prof.links) == len(by_tier)


def test_torch_source_refuses_routes_it_cannot_address():
    msgs = []
    for m, src in ((R, "jax"), (T, "torch")):
        runner = m.CalibrationRunner("tpu_v5e", source=src)
        pool = [r for r in runner.routes() if r[0] == "pool"]
        with pytest.raises(ValueError) as e:
            runner.run(routes=pool)
        msgs.append(str(e.value))
    assert "use source='emulated'" in msgs[1]
    with pytest.raises(ValueError, match="torch|emulated|auto"):
        T.CalibrationRunner(source="jax")


def test_torch_source_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runner = T.CalibrationRunner("tpu_v5e", source="torch", repeats=1)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        runner.run()
    # the emulated source needs no device at all
    assert T.CalibrationRunner("tpu_v5e").run()


# ---------------------------------------------------------------------------
# from_profile, validate, recal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("system", SYSTEMS)
def test_from_profile_matches_reference(system):
    import repro.fabric.systems as rs
    import repro_torch.fabric.systems as ps
    want = rs.from_profile(_profile(R, system)[1])
    got = ps.from_profile(_profile(T, system)[1])
    assert _fabric(got) == _fabric(want)
    assert (got.name, got.provenance, got.description, got.compute,
            got.tier_map, got.kv_tiers) == \
        (want.name, want.provenance, want.description, want.compute,
         want.tier_map, want.kv_tiers)
    assert got.fabric.name == want.fabric.name


def test_from_profile_refuses_a_preset_without_the_route():
    import repro.fabric.systems as rs
    import repro_torch.fabric.systems as ps
    msgs = []
    for m, systems in ((R, rs), (T, ps)):
        with pytest.raises(ValueError) as e:
            systems.from_profile(_profile(m, "cxl_pool")[1],
                                 preset="tpu_v5e")
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_calibrated_tier_topologies_match_reference():
    import repro.core.tiers as rt
    import repro.fabric.systems as rs
    import repro_torch.core.tiers as pt
    import repro_torch.fabric.systems as ps
    out = []
    for m, tiers, systems in ((R, rt, rs), (T, pt, ps)):
        prof = _profile(m)[1]
        a = tiers.TierTopology.from_calibration(prof.tier_measurements())
        b = tiers.TierTopology.from_fabric(systems.from_profile(prof))
        out.append([(x, y, t.link_bw(x, y), t.link_latency(x, y))
                    for t in (a, b) for (x, y) in sorted(t.links)])
    assert out[1] == out[0]


@pytest.mark.parametrize("system", SYSTEMS)
def test_validation_reports_match_reference(system):
    from repro_torch.obs import Tracer as PT
    from repro.obs import Tracer as RT
    out = []
    for m, tracer in ((R, RT), (T, PT)):
        runner, prof = _profile(m, system)
        tr = tracer(clock=lambda: 0.0)
        rep = m.validate_scenarios(prof, runner.truth_system, tracer=tr)
        out.append((rep, rep.max_rel_err, rep.error_reduction,
                    m.validate_samples(prof),
                    [tuple(e) for e in tr.events],
                    tr.metrics.to_json()))
    assert text(out[1]) == text(out[0])
    assert out[1][1] < out[1][0].nominal_max_rel_err


def test_validation_errors_match_reference():
    msgs = []
    for m in (R, T):
        got = []
        prof = dataclasses.replace(_profile(m)[1], system="mi300a")
        for call in (lambda: m.validate_scenarios(prof, None,
                                                  preset="nowhere"),
                     lambda: m.validate_samples(prof, samples=[])):
            with pytest.raises(ValueError) as e:
                call()
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[1] == msgs[0]
    assert sorted(T.REPLAY_SCENARIOS) == sorted(R.REPLAY_SCENARIOS)


def _degraded(side_sys, factor=0.5):
    """tpu_v5e with its host link cut to ``factor`` of its bandwidth."""
    base = side_sys.get_system("tpu_v5e")
    return dataclasses.replace(base, fabric=base.fabric.rescaled(
        {("chip0", "host_dram"): (factor, 1.0)}))


def test_recalibrator_matches_reference():
    import repro.fabric.systems as rs
    import repro.obs as ro
    import repro_torch.fabric.systems as ps
    import repro_torch.obs as po
    out = []
    for m, systems, obs in ((R, rs, ro), (T, ps, po)):
        prof = _profile(m)[1]
        tr = obs.Tracer(clock=lambda: 0.0)
        sent = obs.DriftSentinel(prof, preset="tpu_v5e")
        rc = m.AutoRecalibrator(prof, sentinel=sent, tracer=tr)
        res = rc.recalibrate("host_dram->chip0", truth_system=_degraded(
            systems), ts=1.5)
        again = rc.recalibrate("host_dram->chip0",
                               truth_system=_degraded(systems, 0.25))
        out.append((res, res.time_scale(4 << 20), again, rc.profile,
                    _fabric(res.system), [tuple(e) for e in tr.events],
                    tr.metrics.to_json(), sent.report()))
    assert text(out[1]) == text(out[0])
    assert out[1][0].estimate.bandwidth < out[1][0].old_estimate.bandwidth


def test_recalibrator_refuses_unmapped_routes_as_reference():
    msgs = []
    for m in (R, T):
        rc = m.AutoRecalibrator(_profile(m)[1])
        got = []
        for key in ("chip0", "chip0->host_dram"):
            with pytest.raises(ValueError) as e:
                rc.recalibrate(key, truth_system=None)
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# the calibrated consumers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def profile_path(tmp_path_factory):
    """A tpu_v5e profile as the reference writes it."""
    path = tmp_path_factory.mktemp("profile") / "tpu_v5e.json"
    R.CalibrationRunner("tpu_v5e").calibrate().save(str(path))
    return str(path)


@pytest.mark.parametrize("as_path", [True, False])
def test_calibrated_paged_decode_matches_reference(profile_path, as_path):
    from repro.launch.serve import simulate_paged_decode as ref_sim
    from repro_torch.launch.serve import simulate_paged_decode
    want = ref_sim(requests=4, gen=8, calibration_profile=profile_path)
    prof = profile_path if as_path else T.CalibrationProfile.load(
        profile_path)
    got = simulate_paged_decode(requests=4, gen=8, calibration_profile=prof,
                                device="cpu")
    assert got == want and got["calibrated"] is True
    nominal = simulate_paged_decode(requests=4, gen=8, device="cpu")
    assert got["fp16"] != nominal["fp16"]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_calibrated_disagg_serve_matches_reference(profile_path, kv_dtype):
    from repro.obs import Tracer as RT
    from repro.serving.disagg import DisaggConfig as RC
    from repro.serving.disagg import run_disagg_serve as ref_run
    from repro_torch.obs import Tracer as PT
    from repro_torch.serving.disagg import DisaggConfig, run_disagg_serve
    want = ref_run(RC(system="tpu_v5e", requests=4, kv_dtype=kv_dtype),
                   calibration_profile=profile_path,
                   tracer=RT(clock=lambda: 0.0)).to_json()
    got = run_disagg_serve(
        DisaggConfig(system="tpu_v5e", requests=4, kv_dtype=kv_dtype),
        calibration_profile=profile_path, tracer=PT(clock=lambda: 0.0),
        device="cpu").to_json()
    assert text(got) == text(want)


@pytest.mark.parametrize("recalibrate", [False, True])
def test_calibrated_degraded_serve_matches_reference(monkeypatch,
                                                     profile_path,
                                                     recalibrate):
    import repro.obs as ro
    import repro.runtime.degrade as rd
    import repro_torch.obs as po
    import repro_torch.runtime.degrade as pd
    patch_reference_fetch(monkeypatch)
    out = []
    for obs, deg, m in ((ro, rd, R), (po, pd, T)):
        tr = obs.Tracer(clock=lambda: 0.0)
        prof = m.CalibrationProfile.load(profile_path)
        sent = obs.DriftSentinel(prof, preset="tpu_v5e", tracer=tr)
        kw = {} if m is R else {"device": "cpu"}
        rep = deg.run_degraded_serve(
            deg.host_link_degraded(), cfg=deg.DegradedServeConfig(
                requests=4, prompt=512, gen=8, rounds=10),
            calibration_profile=prof, sentinel=sent,
            recalibrate=recalibrate, tracer=tr, **kw)
        out.append((rep, sent.report(), [tuple(e) for e in tr.events],
                    tr.metrics.to_json()))
    assert text(out[1]) == text(out[0])
    rep = out[1][0]
    assert (rep.recal is not None) == recalibrate
    if recalibrate:                 # tests/test_recal.py's convergence
        assert rep.recal[0]["route"] == "host_dram->chip0"
        assert out[1][1]["flagged"] == []


@pytest.mark.parametrize("args", [
    ["--paged-sim", "--requests", "3", "--gen", "4"],
    ["--disagg-sim", "--system", "tpu_v5e", "--requests", "3"],
    ["--degrade-sim"],
    ["--degrade-sim", "--recalibrate"],
])
def test_cli_calibration_profile_matches_reference_cli(
        monkeypatch, capsys, profile_path, args):
    """``--calibration-profile`` (and ``--recalibrate``) print the
    reference CLI's JSON, byte for byte."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch.serve import main
    patch_reference_fetch(monkeypatch)
    args = [*args, "--calibration-profile", profile_path]
    monkeypatch.setattr(sys, "argv", ["serve", *args])
    ref_serve.main()
    want = capsys.readouterr().out
    main([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want


def test_cli_recalibrate_needs_a_profile(capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit):
        main(["--degrade-sim", "--recalibrate", "--device", "cpu"])
    assert "--recalibrate needs --calibration-profile" in \
        capsys.readouterr().err


def test_exports_match_reference():
    assert sorted(T.__all__) == sorted(R.__all__)
    assert T.PROFILE_VERSION == R.PROFILE_VERSION
    assert T.DEFAULT_MAX_DISPERSION == R.DEFAULT_MAX_DISPERSION


def test_no_calibration_stub_is_left():
    import pathlib
    src = pathlib.Path(__file__).resolve().parents[1] / "src" / \
        "repro_torch"
    for path in src.rglob("*.py"):
        body = path.read_text()
        for i, line in enumerate(body.splitlines()):
            assert not ("NotImplementedError" in line and "calibrat" in
                        "\n".join(body.splitlines()[i:i + 3])), \
                f"{path}:{i + 1}"
