"""repro_torch fabric, transport, serve control plane and kv_quant family
vs the reference's, on the CPU.

These layers are pure Python and numpy (the pagers behind them hold their
pools on ``device="cpu"`` here), so the port must give the reference's
results exactly: the same simulated times, routes, plans and schedules,
float for float.
"""

import dataclasses
import json

import numpy as np
import pytest

MiB = 1 << 20
PRESETS = ["dual_socket_cxl", "cxl_pool", "gh200", "mi300a", "tpu_v5e"]


def _systems(name):
    from repro.fabric.systems import get_system as ref_system
    from repro_torch.fabric.systems import get_system
    return ref_system(name), get_system(name)


def _memory_nodes(system):
    return sorted(n.name for n in system.fabric.nodes.values()
                  if n.kind.value == "memory")


def _flows(system, Flow):
    """One flow from every memory node to the compute node, of mixed sizes,
    starts and QoS classes, plus one the other way."""
    mem = _memory_nodes(system)
    flows = [Flow(f"f{i}", m, system.compute, nbytes=(i + 1) * MiB,
                  start=i * 1e-6, weight=1.0 + i, priority=i % 2)
             for i, m in enumerate(mem)]
    flows.append(Flow("back", system.compute, mem[-1], nbytes=3 * MiB))
    return flows


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_reference(name):
    ref, port = _systems(name)
    assert port.compute == ref.compute and port.tier_map == ref.tier_map
    assert port.kv_tiers == ref.kv_tiers
    assert sorted(port.fabric.nodes) == sorted(ref.fabric.nodes)
    for key, link in ref.fabric.links.items():
        got = port.fabric.links[key]
        assert (got.bandwidth, got.latency, got.type.value) == \
            (link.bandwidth, link.latency, link.type.value)
    for n, node in ref.fabric.nodes.items():
        assert port.fabric.nodes[n].capacity == node.capacity


@pytest.mark.parametrize("name", PRESETS)
def test_simulate_matches_reference(name):
    from repro.fabric.contention import Flow as RefFlow
    from repro.fabric.sim import simulate as ref_simulate
    from repro_torch.fabric.contention import Flow
    from repro_torch.fabric.sim import simulate
    ref, port = _systems(name)
    got = simulate(port.fabric, _flows(port, Flow))
    want = ref_simulate(ref.fabric, _flows(ref, RefFlow))
    assert [r.flow.id for r in got] == [r.flow.id for r in want]
    assert [r.finish for r in got] == [r.finish for r in want]


@pytest.mark.parametrize("name", PRESETS)
def test_route_and_plan_transfers_match_reference(name):
    from repro.fabric.contention import Flow as RefFlow
    from repro.transport import (PageTransfer as RefTransfer,
                                 Route as RefRoute,
                                 plan_transfers as ref_plan)
    from repro_torch.fabric.contention import Flow
    from repro_torch.transport import PageTransfer, Route, plan_transfers
    ref, port = _systems(name)
    for mem in _memory_nodes(ref):
        got = Route.resolve(port, mem, port.compute)
        want = RefRoute.resolve(ref, mem, ref.compute)
        assert [(l.src, l.dst) for l in got.links] == \
            [(l.src, l.dst) for l in want.links]
        assert got.bottleneck_bw == want.bottleneck_bw
        assert got.latency == want.latency
        assert got.transfer_time(5 * MiB, compression=2.0) == \
            want.transfer_time(5 * MiB, compression=2.0)
        other = [m for m in _memory_nodes(ref) if m != mem] or [mem]
        plans = []
        for T, F, plan, route in ((PageTransfer, Flow, plan_transfers,
                                   got),
                                  (RefTransfer, RefFlow, ref_plan, want)):
            transfers = [T(p, MiB * (1 + p % 3), compression=1 + p % 2,
                           priority=1) for p in range(6)]
            bg = (F("bg", other[0], route.dst, nbytes=8 * MiB),)
            plans.append(plan(route, transfers, background=bg))
        got_plan, want_plan = plans
        assert got_plan.order == want_plan.order
        assert got_plan.eta == want_plan.eta
        assert got_plan.total_time == want_plan.total_time
        assert got_plan.effective_bw == want_plan.effective_bw
        assert got_plan.wire_bytes == want_plan.wire_bytes


def _filled(kv_dtype, pkg):
    """tests/test_kv_quant.py's scheduler cache, in either package."""
    if pkg == "ref":
        import jax.numpy as jnp
        from repro.serving.pager import PagedKVCache, PagerConfig
        kv = jnp.zeros((96, 4, 64), jnp.float32)
        kw = {}
    else:
        import torch
        from repro_torch.serving.pager import PagedKVCache, PagerConfig
        kv = torch.zeros(96, 4, 64)
        kw = {"device": "cpu"}
    c = PagedKVCache(PagerConfig(page_size=32, n_pages=96, kv_heads=4,
                                 head_dim=64, weights=(2, 1),
                                 dtype="float32", kv_dtype=kv_dtype), **kw)
    for s in range(4):
        c.allocate(s)
        c.append(s, kv, kv)
    return c


def _schedule_fields(ds, names):
    """The ``names`` fields of a DecodeSchedule (the port's fields, which
    the reference's schedule also has), with its steps, the prefetch plan
    it admitted against and derived figures."""
    d = {n: getattr(ds, n) for n in names if n not in ("steps", "plan")}
    d["steps"] = [dataclasses.astuple(s) for s in ds.steps]
    d["plan"] = (ds.plan.order, ds.plan.eta, ds.plan.total_time,
                 ds.plan.effective_bw)
    d["mean_completion"] = ds.mean_completion
    d["speedup"] = ds.speedup
    return d


def _same_schedule(got, want):
    names = [f.name for f in dataclasses.fields(got)]
    assert _schedule_fields(got, names) == _schedule_fields(want, names)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("system", [None, "gh200"])
def test_decode_scheduler_matches_reference(kv_dtype, system):
    from repro.fabric.systems import get_system as ref_system
    from repro.launch.serve import DecodeScheduler as RefScheduler
    from repro_torch.fabric.systems import get_system
    from repro_torch.launch.serve import DecodeScheduler
    got = DecodeScheduler(_filled(kv_dtype, "port"), step_time=5e-6,
                          system=system and get_system(system)
                          ).schedule([0, 1, 2, 3], 4)
    want = RefScheduler(_filled(kv_dtype, "ref"), step_time=5e-6,
                        system=system and ref_system(system)
                        ).schedule([0, 1, 2, 3], 4)
    _same_schedule(got, want)


def test_admission_schedule_matches_reference():
    from repro.launch.serve import admission_schedule as ref_admit
    from repro_torch.launch.serve import admission_schedule
    from repro_torch.serving.pager import PrefetchPlan
    eta = {10: 3e-6, 11: 9e-6, 12: 2e-5}
    plan = PrefetchPlan((10, 11, 12), eta, 2e-5, 1e9)
    ready = {0: 0.0, 1: 9e-6, 2: 2e-5, 3: 4e-5}
    _same_schedule(admission_schedule(ready, plan, 3, 1e-5),
                   ref_admit(ready, plan, 3, 1e-5))


@pytest.mark.parametrize("system_name", ["tpu_v5e", "gh200"])
def test_simulate_paged_decode_matches_reference(system_name):
    from repro.launch.serve import simulate_paged_decode as ref_sim
    from repro_torch.launch.serve import simulate_paged_decode
    got = simulate_paged_decode(requests=4, gen=8, system_name=system_name,
                                device="cpu")
    want = ref_sim(requests=4, gen=8, system_name=system_name)
    assert got == want
    if system_name == "tpu_v5e":     # test_kv_quant.py's headline bounds
        assert got["bytes_reduction"] >= 1.8
        assert got["prefetch_speedup"] >= 1.5


def test_simulate_paged_decode_refuses_a_calibration_profile(tmp_path):
    """A malformed profile artifact is refused at load time with the
    reference's message; calibrated simulations are held against the
    reference in tests/test_torch_calibrate.py."""
    from repro.calibrate import ProfileError as RefError
    from repro.launch.serve import simulate_paged_decode as ref_sim
    from repro_torch.calibrate import ProfileError
    from repro_torch.launch.serve import simulate_paged_decode
    path = tmp_path / "profile.json"
    path.write_text(json.dumps({"version": 1, "system": "tpu_v5e"}))
    with pytest.raises(RefError) as want:
        ref_sim(calibration_profile=str(path))
    with pytest.raises(ProfileError) as got:
        simulate_paged_decode(calibration_profile=str(path), device="cpu")
    assert str(got.value) == str(want.value) == \
        "links: missing required field"
    with pytest.raises(FileNotFoundError):
        simulate_paged_decode(calibration_profile=str(tmp_path / "none"),
                              device="cpu")


def test_kv_quant_family_matches_reference():
    from repro.heimdall import kv_quant as ref
    from repro_torch.heimdall import kv_quant as port
    for name in ("kv_quant_bytes_moved", "kv_quant_prefetch_sim",
                 "kv_quant_decode_schedule"):
        got = [r.csv() for r in getattr(port, name)(device="cpu")]
        want = [r.csv() for r in getattr(ref, name)()]
        assert got == want, name
    assert port.bench_summary(device="cpu") == ref.bench_summary()


def test_kv_quant_kernel_wall_runs_on_the_cpu():
    from repro_torch.heimdall.kv_quant import kv_quant_kernel_wall
    rows = kv_quant_kernel_wall(device="cpu")
    assert [r.name for r in rows] == ["kv_quant_kernel/fp",
                                      "kv_quant_kernel/int8"]
    assert all(np.isfinite(r.us_per_call) and r.us_per_call > 0
               for r in rows)
    assert "device=cpu" in rows[0].derived


def test_compression_model_matches_reference():
    from repro.core import compression as ref
    from repro_torch.core import compression as port
    for dtype in ("bfloat16", "float32"):
        for block in (256, 8192):
            assert port.int8_compression_factor(dtype, block) == \
                ref.int8_compression_factor(dtype, block)
    assert port.expected_int8_rel_error(8192) == \
        ref.expected_int8_rel_error(8192)


def test_place_puts_tiers_on_the_cpu_without_pinning():
    import torch
    from repro_torch.heimdall.harness import place
    x = torch.ones(4)
    assert place(x, "hbm", "cpu").device.type == "cpu"
    host = place(x, "host", "cpu")
    assert host.device.type == "cpu" and not host.is_pinned()
    with pytest.raises(ValueError, match="unknown tier"):
        place(x, "pool", "cpu")


def test_interleave_matches_reference():
    from repro.core.placement import interleave_counts as ref_counts
    from repro.core.placement import interleave_pages as ref_pages
    from repro_torch.core.placement import (interleave_counts,
                                            interleave_pages)
    for n, w in ((536, (2, 1)), (17, (1, 0)), (31, (3, 2, 1))):
        np.testing.assert_array_equal(interleave_pages(n, w),
                                      ref_pages(n, w))
        assert interleave_counts(n, w) == ref_counts(n, w)
    with pytest.raises(ValueError):
        interleave_pages(4, (0, 0))
