"""repro_torch's cost model, tiers, KV placement and fabric scenarios vs the
reference's.

All four are pure arithmetic over the same published constants, with no
JAX, so the tolerance is equality: each case runs the same inputs through
both packages and compares the results as JSON text. The cases mirror
tests/test_costmodel.py, tests/test_placement.py and the scenarios of
tests/test_fabric.py, each also asserting the property the reference's
test states.
"""

import dataclasses
import importlib
import json
import random

import pytest

MiB = 1 << 20
SIDES = ("repro", "repro_torch")
SYSTEMS = ["tpu_v5e", "gh200", "mi300a", "cxl_pool", "dual_socket_cxl"]
KW = dict(model_bytes=130 << 30, hbm_capacity=72 << 30, link_bw=25 << 30,
          kv_bytes_per_seq=200 << 20, flops_per_token=2 * 70e9,
          peak_flops=900e12, hbm_bw=3 << 40, max_concurrency=150)


def mod(side: str, name: str):
    return importlib.import_module(f"{side}.{name}")


def _plain(x):
    if dataclasses.is_dataclass(x):
        return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, (set, frozenset)):
        return sorted(x)
    raise TypeError(f"cannot compare {type(x).__name__}")


def text(x) -> str:
    return json.dumps(x, sort_keys=True, default=_plain)


def same(fn):
    """``fn(side)`` for the reference and the port, equal as JSON text;
    returns the port's result."""
    want, got = (fn(side) for side in SIDES)
    assert text(got) == text(want)
    return got


def _topo(side):
    return mod(side, "core.tiers").TierTopology.tpu_v5e()


def _system(side, name):
    return mod(side, "fabric.systems").get_system(name)


def _tiers_json(topo):
    return {"tiers": {k: dataclasses.asdict(v)
                      for k, v in sorted(topo.tiers.items())},
            "links": sorted((list(k), dataclasses.asdict(v))
                            for k, v in topo.links.items())}


# ---------------------------------------------------------------------------
# tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chips", [1, 4, 8])
def test_tpu_v5e_topology_matches_reference(chips):
    def go(side):
        topo = mod(side, "core.tiers").TierTopology.tpu_v5e(chips)
        pairs = [("hbm", "host"), ("host", "hbm"), ("hbm", "pool"),
                 ("peer_hbm", "hbm"), ("pool", "host")]
        return {**_tiers_json(topo),
                "bw": [topo.link_bw(a, b) for a, b in pairs],
                "lat": [topo.link_latency(a, b) for a, b in pairs]}
    same(go)


@pytest.mark.parametrize("system", SYSTEMS)
def test_from_fabric_matches_reference(system):
    def go(side):
        return _tiers_json(mod(side, "core.tiers").TierTopology.from_fabric(
            _system(side, system)))
    same(go)


def test_from_calibration_and_missing_link_match_reference():
    meas = {"hbm": dict(capacity=80 << 30, read_bw=3e12, write_bw=3e12,
                        latency=5e-7, memory_kind="device"),
            "host": dict(capacity=1 << 40, read_bw=5e10, write_bw=4e10,
                         latency=2e-6, memory_kind="pinned_host"),
            "pool": dict(capacity=4 << 40, read_bw=2e10, write_bw=2e10,
                         latency=6e-6, memory_kind=None)}

    def go(side):
        T = mod(side, "core.tiers").TierTopology
        topo = T.from_calibration(meas)
        with pytest.raises(KeyError):
            T.tpu_v5e().link_bw("hbm", "nowhere")
        return {**_tiers_json(topo),
                "addressable": mod(side, "core.tiers").ADDRESSABLE}
    got = same(go)
    assert got["links"][0][1]["latency"] == pytest.approx(5e-7 + 2e-6)


# ---------------------------------------------------------------------------
# cost model: tests/test_costmodel.py's cases, in both packages
# ---------------------------------------------------------------------------


def test_fig5_bandwidth_saturates_as_reference():
    def go(side):
        cm = mod(side, "core.costmodel")
        t = _topo(side).tier("host")
        return [cm.bandwidth_vs_concurrency(t, n, bytes_inflight=b)
                for n in (1, 2, 4, 8, 64) for b in (4096, 64 * 1024)]
    bws = same(go)[5:]
    assert all(b2 >= b1 for b1, b2 in zip(bws, bws[1:]))
    assert bws[-1] == _topo("repro_torch").tier("host").read_bw


def test_fig6_loaded_latency_blows_up_as_reference():
    def go(side):
        cm = mod(side, "core.costmodel")
        t = _topo(side).tier("host")
        return [cm.loaded_latency(t, u * t.read_bw)
                for u in (0.0, 0.1, 0.5, 0.9, 0.99)]
    lat = same(go)
    assert lat[1] < lat[2] < lat[3]
    assert lat[3] > 5 * _topo("repro_torch").tier("host").latency


def test_fig7_interleave_optimum_as_reference():
    def go(side):
        cm = mod(side, "core.costmodel")
        topo = _topo(side)
        tiers = [topo.tier("hbm"), topo.tier("host")]
        ws = cm.optimal_interleave_weights(tiers)
        three = [topo.tier(t) for t in ("hbm", "host", "pool")]
        with pytest.raises(ValueError):
            cm.interleave_bandwidth(tiers, [0, 0])
        ratio = int(round(tiers[0].read_bw / tiers[1].read_bw))
        return {"ws": ws,
                "ws3": [cm.optimal_interleave_weights(three, m)
                        for m in (1, 4, 8, 16)],
                "bw": [cm.interleave_bandwidth(tiers, w)
                       for w in ([1, 0], [1, 1], ws, [0, 1], [ratio, 1])]}
    got = same(go)
    assert got["ws"][0] > got["ws"][1] >= 0
    # hbm-only < weighted both: the aggregate bandwidth grows
    assert got["bw"][2] >= got["bw"][1] and got["bw"][4] > got["bw"][0]


@pytest.mark.parametrize("overlap", [0.0, 0.5, 1.0])
def test_table5_sweep_matches_reference(overlap):
    def go(side):
        return [dataclasses.asdict(p) for p in
                mod(side, "core.costmodel").offload_sweep(
                    **KW, overlap=overlap)]
    tps = [p["tokens_per_s"] for p in same(go)]
    peak = max(range(len(tps)), key=lambda i: tps[i])
    if overlap == 0.0:
        assert 0 < peak < len(tps) - 1 and tps[-1] < tps[peak]


def test_table6_proportionality_and_overlap_as_reference():
    def go(side):
        cm = mod(side, "core.costmodel")
        fast = cm.optimal_offload(**KW)
        slow = cm.optimal_offload(**{**KW, "link_bw": int((25 << 30) / 2.81)})
        over = cm.optimal_offload(**{**KW, "overlap": 1.0})
        return [dataclasses.asdict(p) for p in (fast, slow, over)]
    fast, slow, over = same(go)
    assert 2.3 <= fast["tokens_per_s"] / slow["tokens_per_s"] <= 2.81 * 1.1
    assert over["tokens_per_s"] >= fast["tokens_per_s"]


def test_offload_throughput_over_seeded_sizes_as_reference():
    rng = random.Random(0)
    sizes = [0, 130 << 30, 58 << 30] + [rng.randint(0, 130 << 30)
                                        for _ in range(50)]

    def go(side):
        cm = mod(side, "core.costmodel")
        out = [dataclasses.asdict(cm.offload_throughput(offload_bytes=ob,
                                                        **KW))
               for ob in sizes]
        out.append(dataclasses.asdict(cm.offload_throughput(
            offload_bytes=0, **{**KW, "model_bytes": 80 << 30})))
        out.append(dataclasses.asdict(cm.offload_throughput(
            offload_bytes=10 << 30, **{**KW, "kv_bytes_per_seq": 1 << 40})))
        return out
    for p in same(go):
        assert p["tokens_per_s"] >= 0
        assert p["bound"] in ("compute", "transfer", "capacity")


@pytest.mark.parametrize("system", SYSTEMS)
def test_transfer_times_match_reference(system):
    def go(side):
        cm = mod(side, "core.costmodel")
        Flow = mod(side, "fabric.contention").Flow
        sysm = _system(side, system)
        topo = mod(side, "core.tiers").TierTopology.from_fabric(sysm)
        kv = sysm.kv_tiers or tuple(sysm.tier_map)[:1] * 2
        fast, slow = kv
        bg = (Flow("offload", slow, fast, nbytes=256 * MiB),)
        out = {"tpu_topo": [cm.transfer_time(nb, _topo(side), "hbm", "host",
                                             compression=c)
                            for nb in (4096, 160 * MiB) for c in (1.0, 2.0)]}
        if fast != slow:
            out["fabric"] = [cm.transfer_time(nb, sysm, slow, fast,
                                              compression=c)
                             for nb in (4096, 160 * MiB)
                             for c in (1.0, 1.97)]
            out["tiers"] = cm.transfer_time(160 * MiB, topo, slow, fast)
            out["contended"] = [
                cm.contended_transfer_time(64 * MiB, sysm, slow, fast, b,
                                           compression=c, weight=w,
                                           priority=p)
                for b in ((), bg) for c in (1.0, 2.0)
                for w, p in ((1.0, 0), (4.0, 0), (1.0, 1))]
        with pytest.raises(ValueError):
            cm.transfer_time(1, _topo(side), "hbm", "host", compression=0)
        return out
    got = same(go)
    assert 0.001 < got["tpu_topo"][2] < 1.0      # ~20 ms at 8 GB/s a chip


# ---------------------------------------------------------------------------
# placement: plan_kv_placement plain and with system= / background=
# ---------------------------------------------------------------------------


def _configs(side):
    """Every architecture the reference registers, full and reduced, as
    each package's ModelConfig."""
    from repro.config.base import get_config, list_archs
    cfgs = []
    for arch in list_archs():
        for c in (get_config(arch), get_config(arch).reduced()):
            cfgs.append(c if side == "repro" else _port_cfg(c))
    return cfgs


def _port_cfg(jcfg):
    from repro_torch.config.base import MLAConfig, ModelConfig, MoEConfig
    kw = dataclasses.asdict(jcfg)
    if kw["moe"] is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    if kw["mla"] is not None:
        kw["mla"] = MLAConfig(**kw["mla"])
    return ModelConfig(**kw)


SHAPES = [("decode_32k", 32768, 64), ("decode_4k", 4096, 8),
          ("long_128k", 131072, 1)]


def _shape(side, s):
    return mod(side, "config.base").ShapeConfig(s[0], s[1], s[2], "decode")


@pytest.mark.parametrize("compression", [1.0, 1.97])
def test_plan_kv_placement_plain_matches_reference(compression):
    def go(side):
        pl = mod(side, "core.placement")
        out = []
        for cfg in _configs(side):
            for s in SHAPES:
                for chips in (1, 8, 256):
                    out.append(pl.plan_kv_placement(
                        cfg, _shape(side, s), chips,
                        kv_compression=compression))
                    out.append(pl._kv_bytes_per_chip(cfg, _shape(side, s),
                                                     chips))
        with pytest.raises(ValueError):
            pl.plan_kv_placement(_configs(side)[0], _shape(side, SHAPES[0]),
                                 1, kv_compression=0.0)
        return out
    got = same(go)
    kinds = {p["kv"] for p in got if isinstance(p, dict)}
    assert kinds == {"device", "interleaved"}


@pytest.mark.parametrize("system", SYSTEMS)
def test_plan_kv_placement_on_fabric_matches_reference(system):
    def go(side):
        pl = mod(side, "core.placement")
        Flow = mod(side, "fabric.contention").Flow
        sysm = _system(side, system)
        slow = sysm.kv_tiers[1] if sysm.kv_tiers else None
        fast = sysm.kv_tiers[0] if sysm.kv_tiers else None
        bgs = [()]
        if slow:
            bgs += [(Flow("noisy", slow, fast, nbytes=512 * MiB),),
                    (Flow("noisy", slow, fast, nbytes=512 * MiB,
                          priority=1),),
                    (Flow("a", slow, fast), Flow("b", slow, fast,
                                                 weight=3.0))]
        out = []
        for cfg in _configs(side)[::3]:
            for s in SHAPES:
                for bg in bgs:
                    for w, p, c in ((1.0, 0, 1.0), (4.0, 0, 1.97),
                                    (1.0, 1, 1.0)):
                        out.append(pl.plan_kv_placement(
                            cfg, _shape(side, s), 1, system=sysm,
                            background=bg, kv_compression=c, flow_weight=w,
                            flow_priority=p))
        for bg in bgs:
            out.append(pl.contended_tier_bandwidths(sysm, bg))
            out.append(pl.contended_tier_bandwidths(sysm, bg, weight=2.0,
                                                    priority=1))
        return out
    same(go)


def test_kv_placement_shifts_to_the_quiet_tier_under_noise():
    """The reference's contention property, in the port: a noisy
    neighbour on the spill link moves pages toward the fast tier, and a
    prioritized KV class recovers the quiet-link plan."""
    from repro_torch.config.base import ShapeConfig
    from repro_torch.core.placement import plan_kv_placement
    from repro_torch.fabric import Flow, get_system
    cfg = _port_cfg(__import__("repro.config.base", fromlist=["x"])
                    .get_config("qwen2-72b"))
    sysm = get_system("gh200")
    shape = ShapeConfig("d", 32768, 64, "decode")
    noise = (Flow("noisy", "host", "hbm", nbytes=8 << 30),)
    quiet = plan_kv_placement(cfg, shape, 1, system=sysm)
    loud = plan_kv_placement(cfg, shape, 1, system=sysm, background=noise)
    prio = plan_kv_placement(cfg, shape, 1, system=sysm, background=noise,
                             flow_priority=1)
    assert quiet["kv"] == "interleaved"
    assert loud["effective_bw"]["host"] < quiet["effective_bw"]["host"]
    assert prio["kv_interleave"] == quiet["kv_interleave"]


def test_optimal_weights_proportional_to_bandwidth_as_reference():
    def go(side):
        cm = mod(side, "core.costmodel")
        topo = mod(side, "core.tiers").TierTopology.tpu_v5e()
        tiers = [topo.tier("hbm"), topo.tier("host")]
        ws = cm.optimal_interleave_weights(tiers)
        return [ws, cm.interleave_bandwidth(tiers, ws),
                cm.interleave_bandwidth(tiers, [1, 1])]
    ws, best, naive = same(go)
    assert ws[0] > ws[1] >= 0 and best >= naive


@pytest.mark.parametrize("arch,expect_offload", [
    ("yi-9b", False), ("qwen2-72b", False), ("deepseek-v3-671b", True)])
def test_training_placement_on_a_pod_as_reference(arch, expect_offload):
    from repro.config.base import get_config
    from repro.core.placement import plan_training_placement as ref_plan
    from repro_torch.core.placement import plan_training_placement
    plan = plan_training_placement(_port_cfg(get_config(arch)), 256)
    assert dataclasses.asdict(plan) == \
        dataclasses.asdict(ref_plan(get_config(arch), 256))
    assert any(v != "device" for v in plan.kinds.values()) == expect_offload
    assert plan.fits and plan.hbm_used <= plan.hbm_capacity


# ---------------------------------------------------------------------------
# fabric scenarios
# ---------------------------------------------------------------------------


def _scenario_json(r):
    return {"name": r.name, "system": r.system.name, "solo": r.solo,
            "slowdown": r.slowdown,
            "results": [[x.flow.id, x.flow.start, x.finish, x.duration,
                         x.achieved_bandwidth] for x in r.results]}


@pytest.mark.parametrize("name,kw", [
    ("noisy_neighbor_pool", {}), ("noisy_neighbor_pool", {"n_neighbors": 4}),
    ("offload_vs_prefetch", {}), ("qos_prefetch_over_bulk", {}),
    ("qos_prefetch_over_bulk", {"priority": 0, "weight": 4.0}),
    ("bidirectional_fight", {})])
def test_scenarios_match_reference(name, kw):
    def go(side):
        sc = mod(side, "fabric.scenarios")
        r = sc.ALL_SCENARIOS[name](**kw)
        out = _scenario_json(r)
        out["first"] = r.result(r.results[0].flow.id).flow.id
        return out
    got = same(go)
    assert all(v >= 1.0 - 1e-9 for k, v in got["slowdown"].items()
               if k != "kv_prefetch" or name != "qos_prefetch_over_bulk")


def test_scenario_registry_matches_reference():
    import repro.fabric as ref
    import repro_torch.fabric as port
    assert sorted(port.ALL_SCENARIOS) == sorted(ref.ALL_SCENARIOS)
    assert sorted(port.__all__) == sorted(ref.__all__)
