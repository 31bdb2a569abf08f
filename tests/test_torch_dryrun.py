"""The dry-run and its roofline (repro_torch.launch.dryrun,
roofline.{hlo_walk, analysis, hw}, launch.inputs.input_specs, the abstract
trees) vs the reference.

The walker runs the torch counterparts of ``tests/test_roofline.py``'s
functions: its matmul FLOPs equal the analytic count the reference's
walker is held to, its totals are within that file's 20% of the reference
walker's. On a fake 2x2 mesh (the ``fake`` process-group backend, one
process) a sharded MLP and attention block give per-chip matmul FLOPs and
collective bytes by kind equal to the analytic counts. ``Roofline``,
``model_flops_per_step`` and ``summarize`` equal the reference's on the
same inputs. On the fake 16x16 production mesh, ``input_specs`` and the
abstract parameter, cache and train-state trees have the reference's
shapes, dtypes and per-chip shard shapes (the reference's side on a jax
``AbstractMesh``). ``lower_cell`` of reduced archs runs in a subprocess
for each shape kind.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.config.base import get_config as jax_get_config
from repro.config.base import get_shape as jax_get_shape
from repro.roofline import analysis as jax_analysis
from repro.roofline import hw as jax_hw
from repro.roofline.hlo_walk import analyze as jax_analyze
from repro_torch.config.base import ParallelConfig, get_config, get_shape
from repro_torch.models.params import abstract_leaf
from repro_torch.roofline import analysis, hw
from repro_torch.roofline.hlo_walk import analyze

ROOT = Path(__file__).resolve().parents[1]


def _leaf(*shape):
    return abstract_leaf(shape, torch.float32, device="cpu")


def _jax_walk(fn, *shapes):
    sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jax_analyze(jax.jit(fn).lower(*sds).compile().as_text())


# --------------------------------------------------------------------------
# The walker against the reference's
# --------------------------------------------------------------------------


def test_layer_loop_counted_whole():
    def jf(params, x):
        def body(c, p):
            return jnp.tanh(c @ p), None
        out, _ = jax.lax.scan(body, x, params)
        return out.sum()

    def tf(params, x):
        c = x
        for p in torch.unbind(params):
            c = torch.tanh(c @ p)
        return c.sum()
    want = _jax_walk(jf, (7, 16, 16), (4, 16))
    got = analyze(tf, _leaf(7, 16, 16), _leaf(4, 16))
    dots = 7 * 2 * 4 * 16 * 16
    assert got["dot_flops"] == dots
    assert dots <= got["flops"] <= dots * 1.2
    assert abs(got["flops"] - want["flops"]) / want["flops"] < 0.2


@pytest.mark.parametrize("cell", ["slstm", "mlstm"])
def test_trip_counted_recurrence_equals_the_whole_loop(monkeypatch, cell):
    """An xLSTM cell's loop (the sLSTM's steps, the mLSTM's chunks) under
    a walk runs one iteration inside ``trips(n)`` each way; its counts
    equal those of all n iterations issued one by one, forward and
    backward, and the reference's walker counts the cell's scan within its
    usual 20%."""
    from repro.models import xlstm as jax_xlstm
    from repro_torch.models import xlstm
    from repro_torch.roofline import hlo_walk
    cfg = get_config("xlstm-350m").reduced(dtype="float32")
    jcfg = jax_get_config("xlstm-350m").reduced(dtype="float32")
    specs = getattr(xlstm, f"{cell}_specs")(cfg)
    forward = getattr(xlstm, f"{cell}_forward")

    def fwd(p, x):
        if cell == "mlstm":
            return forward(p, x, cfg, chunk=8)[0].sum()
        return forward(p, x, cfg)[0].sum()

    def train(p, x):
        leaves = {k: v.requires_grad_() for k, v in p.items()}
        fwd(leaves, x.requires_grad_()).backward()

    def walks():                  # fresh leaves: no .grad from a last walk
        return {f.__name__: analyze(
            f, {k: _leaf(*s.shape) for k, s in specs.items()},
            _leaf(2, 24, cfg.d_model)) for f in (fwd, train)}
    trips = walks()
    monkeypatch.setattr(hlo_walk, "walking", lambda: False)
    whole = walks()
    for k in trips:
        for key in ("flops", "dot_flops", "bytes"):
            assert trips[k][key] == whole[k][key], (k, key)
    jspecs = getattr(jax_xlstm, f"{cell}_specs")(jcfg)
    shapes = [s.shape for s in jspecs.values()]

    def jfwd(x, *ws):
        p = dict(zip(jspecs, ws))
        jforward = getattr(jax_xlstm, f"{cell}_forward")
        if cell == "mlstm":
            return jforward(p, x, jcfg, chunk=8)[0].sum()
        return jforward(p, x, jcfg)[0].sum()
    want = _jax_walk(jfwd, (2, 24, jcfg.d_model), *shapes)
    assert abs(trips["fwd"]["dot_flops"] - want["flops"]) <= \
        0.2 * want["flops"]


def test_nested_loops():
    def jg(w):
        def inner(c, wi):
            return c @ wi, None

        def outer(c, wo):
            c, _ = jax.lax.scan(inner, c, wo)
            return c, None
        c, _ = jax.lax.scan(outer, jnp.ones((8, 8)), w)
        return c.sum()

    def tg(w):
        c = torch.ones(8, 8)
        for wo in torch.unbind(w):
            for wi in torch.unbind(wo):
                c = c @ wi
        return c.sum()
    want = _jax_walk(jg, (3, 5, 8, 8))
    got = analyze(tg, _leaf(3, 5, 8, 8))
    assert got["dot_flops"] == 3 * 5 * 2 * 8 ** 3
    assert abs(got["flops"] - want["flops"]) / want["flops"] < 0.2


def test_batched_dot_exact():
    def h(a, b):
        return jnp.einsum("bij,bjk->bik", a, b).sum()
    want = _jax_walk(h, (2, 4, 8), (2, 8, 16))
    got = analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b).sum(),
                  _leaf(2, 4, 8), _leaf(2, 8, 16))
    exact = 2 * 2 * 4 * 8 * 16 + 2 * 4 * 16
    assert got["dot_flops"] == 2 * 2 * 4 * 8 * 16
    assert got["flops"] == exact
    assert abs(want["flops"] - exact) <= 2 * 4 * 16 + 64


def test_against_cost_analysis_unscanned():
    def f(a, b):
        return jax.nn.relu(a @ b).sum()
    a = jax.ShapeDtypeStruct((128, 256), jnp.float32)
    b = jax.ShapeDtypeStruct((256, 64), jnp.float32)
    comp = jax.jit(f).lower(a, b).compile()
    ca = comp.cost_analysis()
    cost = dict(ca[0] if isinstance(ca, (list, tuple)) else ca)
    got = analyze(lambda a, b: torch.relu(a @ b).sum(), _leaf(128, 256),
                  _leaf(256, 64))
    assert got["dot_flops"] == 2 * 128 * 256 * 64
    assert abs(got["flops"] - cost["flops"]) / cost["flops"] < 0.2
    want = jax_analyze(comp.as_text())
    assert abs(got["flops"] - want["flops"]) / want["flops"] < 0.2
    assert set(got) >= {"flops", "bytes", "collective_bytes",
                        "collectives_by_kind", "warnings"}
    assert set(got["collectives_by_kind"]) == set(
        want["collectives_by_kind"])


def test_backward_counted():
    def loss(w, x):
        w = w.requires_grad_()
        (g,) = torch.autograd.grad(torch.tanh(x @ w).sum(), [w])
        return g
    got = analyze(loss, _leaf(64, 32), _leaf(16, 64))
    # forward and the weight gradient's product; x needs no gradient
    assert got["dot_flops"] == 2 * (2 * 16 * 64 * 32)


# --------------------------------------------------------------------------
# Sharded blocks on a fake 2x2 mesh: per-chip counts
# --------------------------------------------------------------------------


@pytest.fixture
def fake_world():
    """A fake default process group of 256 ranks (no traffic) for one
    test."""
    from repro_torch.launch.dryrun import fake_world as init
    assert not dist.is_initialized()
    init(256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mctx(parallel, shape=(2, 2)):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.context import MCtx
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    return MCtx(parallel, torch.device("cpu"), mesh=mesh)


def _placed(mctx, shape, axes, rules=None):
    from repro_torch.models.sharding import named_sharding
    return abstract_leaf(shape, torch.float32, named_sharding(
        mctx.mesh, rules or mctx.rules, axes, shape))


FP32 = 4
Bt, St, D, FF = 8, 16, 64, 256          # batch, seq, d_model, d_ff


@pytest.mark.parametrize("fsdp,sp", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_sharded_mlp_counts(fake_world, fsdp, sp):
    from repro_torch.models import tp
    mctx = _mctx(ParallelConfig(fsdp=fsdp, seq_parallel=sp))
    x = _placed(mctx, (Bt, St, D), ("act_batch", None, None))
    p = {"w_gate": _placed(mctx, (D, FF), ("embed", "mlp")),
         "w_up": _placed(mctx, (D, FF), ("embed", "mlp")),
         "w_down": _placed(mctx, (FF, D), ("mlp", "embed"))}

    def block(x, p):
        f = tp.mlp(mctx, p, x)
        return mctx.constrain(f, ("act_batch", "act_seq", "act_embed"))
    got = analyze(block, x, p)
    rows = Bt // 2 * St                             # this rank's tokens
    assert got["dot_flops"] == 3 * 2 * rows * D * (FF // 2)
    want = {k: 0.0 for k in got["collectives_by_kind"]}
    if fsdp:        # each weight gathered over 'data' to (D, FF / 2)
        want["all-gather"] = 3 * D * (FF // 2) * FP32
    if sp:          # the row-parallel partial sums reduce-scattered
        want["reduce-scatter"] = rows // 2 * D * FP32
    else:
        want["all-reduce"] = rows * D * FP32
    assert got["collectives_by_kind"] == want


def test_sharded_attention_counts(fake_world):
    from repro_torch.models import tp
    cfg = get_config("yi-9b").reduced(dtype="float32")
    Hq, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    d = cfg.d_model
    mctx = _mctx(ParallelConfig(fsdp=False, seq_parallel=True))
    h = _placed(mctx, (Bt, St, d), ("act_batch", None, None))
    p = {"w_q": _placed(mctx, (d, Hq, dh), ("embed", "heads", None)),
         "w_k": _placed(mctx, (d, Hkv, dh), ("embed", "kv_heads", None)),
         "w_v": _placed(mctx, (d, Hkv, dh), ("embed", "kv_heads", None)),
         "w_o": _placed(mctx, (Hq, dh, d), ("heads", None, "embed"))}
    pos = torch.arange(St)[None].expand(Bt, St)

    def block(h, p):
        a, _ = tp.attn_forward(p, h, pos, cfg, mctx, causal=True, window=0,
                               use_rope=True, q_chunk=512)
        return mctx.constrain(a, ("act_batch", "act_seq", "act_embed"))
    got = analyze(block, h, p)
    rows, hq, hkv = Bt // 2 * St, Hq // 2, Hkv // 2
    proj = 2 * rows * d * (hq + 2 * hkv) * dh + 2 * rows * hq * dh * d
    scores = 2 * (Bt // 2) * hq * St * St * dh     # q.k and p.v, unmasked
    assert got["dot_flops"] == proj + 2 * scores
    want = {k: 0.0 for k in got["collectives_by_kind"]}
    want["reduce-scatter"] = rows // 2 * d * FP32
    assert got["collectives_by_kind"] == want


# --------------------------------------------------------------------------
# Roofline arithmetic
# --------------------------------------------------------------------------


def test_hw_constants_match_reference():
    for name in ("PEAK_FLOPS_BF16", "PEAK_FLOPS_INT8", "HBM_BANDWIDTH",
                 "HBM_CAPACITY", "ICI_LINK_BANDWIDTH", "ICI_LINKS_PER_CHIP",
                 "VMEM_CAPACITY", "PCIE_BANDWIDTH", "HOST_DRAM_BANDWIDTH",
                 "HOST_DRAM_CAPACITY", "HOST_DRAM_LATENCY",
                 "HOST_REMOTE_LATENCY", "CXL_LIKE_LATENCY", "POOL_LATENCY",
                 "DCN_BANDWIDTH_PER_HOST", "CHIPS_PER_HOST", "MXU_DIM",
                 "LANE_DIM", "SUBLANE_DIM"):
        assert getattr(hw, name) == getattr(jax_hw, name), name
    import dataclasses
    assert dataclasses.asdict(hw.V5E) == dataclasses.asdict(jax_hw.V5E)
    assert hw.V5E.ridge_intensity == jax_hw.V5E.ridge_intensity


@pytest.mark.parametrize("arch,shape", [("yi-9b", "train_4k"),
                                        ("mixtral-8x22b", "prefill_32k"),
                                        ("deepseek-v3-671b", "decode_32k")])
def test_roofline_matches_reference(arch, shape):
    kw = dict(arch=arch, shape=shape, mesh="16x16", flops=3.1e14,
              hbm_bytes=2.2e12, collective_bytes=4.4e10,
              peak_memory=12345, collective_detail={"all-reduce": 1.0})
    for backward in (True, False):
        mf = analysis.model_flops_per_step(get_config(arch),
                                           get_shape(shape), 256, backward)
        jmf = jax_analysis.model_flops_per_step(
            jax_get_config(arch), jax_get_shape(shape), 256, backward)
        assert mf == jmf
    got = analysis.Roofline.build(model_flops=mf, **kw)
    want = jax_analysis.Roofline.build(model_flops=jmf, **kw)
    assert got.to_json() == want.to_json()
    assert got.step_time == want.step_time
    assert got.roofline_fraction == want.roofline_fraction
    assert analysis.summarize([got, got]) == jax_analysis.summarize(
        [want, want])
    chip = hw.ChipSpec(name="card", peak_flops=7e14, hbm_bandwidth=3e12,
                       ici_bandwidth=3e12)
    assert analysis.Roofline.build(model_flops=mf, chip=chip,
                                   **kw).t_compute == 3.1e14 / 7e14


def test_collective_stats_from_op_record():
    record = [("_c10d_functional::all_reduce", "all-reduce", 64),
              ("aten::mm", 1024.0, 96),
              ("_c10d_functional::all_gather_into_tensor", "all-gather", 32),
              ("_c10d_functional::all_reduce", "all-reduce", 16)]
    got = analysis.collective_stats(record)
    assert got["total_bytes"] == 112
    assert got["bytes_by_kind"]["all-reduce"] == 80
    assert got["counts"] == {"all-reduce": 2, "all-gather": 1,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 0}


# --------------------------------------------------------------------------
# Abstract inputs on the production mesh
# --------------------------------------------------------------------------


def _jax_mesh():
    from jax.sharding import AbstractMesh
    return AbstractMesh((16, 16), ("data", "model"))


def _compare(got, want, what):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _compare(got[k], want[k], f"{what}/{k}")
        return
    assert tuple(got.shape) == tuple(want.shape), what
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what
    assert tuple(got.to_local().shape) == tuple(
        want.sharding.shard_shape(want.shape)), what
    kind = want.sharding.memory_kind or "device"
    assert getattr(got, "memory_kind", "device") == kind, what


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x22b", "qwen2-vl-72b",
                                  "deepseek-v3-671b", "zamba2-7b",
                                  "xlstm-350m", "whisper-small"])
def test_abstract_trees_match_reference(fake_world, arch):
    from repro.core.placement import plan_training_placement as jax_plan
    from repro.launch.inputs import input_specs as jax_input_specs
    from repro.models.model import Model as JaxModel
    from repro.training.step import abstract_train_state as jax_state
    from repro_torch.core.placement import plan_training_placement
    from repro_torch.launch.inputs import input_specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import Model
    from repro_torch.training.step import abstract_train_state
    jm = JaxModel.create(jax_get_config(arch), _jax_mesh(),
                         JaxParallelConfig())
    m = Model.create(get_config(arch), ParallelConfig(),
                     mesh=make_production_mesh(device_type="cpu"))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        _compare(input_specs(m.cfg, get_shape(shape), m.mctx),
                 jax_input_specs(jm.cfg, jax_get_shape(shape), jm.mctx),
                 shape)
    _compare(m.abstract_params(dtype=torch.bfloat16),
             jm.abstract_params(dtype=jnp.bfloat16), "params")
    _compare(m.abstract_cache(128, 32768), jm.abstract_cache(128, 32768),
             "cache")
    if m.cfg.sub_quadratic:         # long_500k: the sequence-sharded cache
        jl = JaxModel.create(jm.cfg, _jax_mesh(), JaxParallelConfig(),
                             seq_sharded_cache=True)
        ml = Model.create(m.cfg, ParallelConfig(), seq_sharded_cache=True,
                          mesh=make_production_mesh(device_type="cpu"))
        _compare(input_specs(ml.cfg, get_shape("long_500k"), ml.mctx),
                 jax_input_specs(jl.cfg, jax_get_shape("long_500k"),
                                 jl.mctx), "long_500k")
        _compare(ml.abstract_cache(1, 524288), jl.abstract_cache(1, 524288),
                 "long_500k cache")
    for policy in ("auto", "always"):
        got = abstract_train_state(m, plan_training_placement(
            m.cfg, 256, policy=policy))
        want = jax_state(jm, jax_plan(jm.cfg, 256, policy=policy))
        _compare(got[0], want[0], "params_c")
        _compare(got[1], want[1], "master")
        _compare(got[2].mu, want[2].mu, "mu")
        _compare(got[2].nu, want[2].nu, "nu")
        assert tuple(got[2].count.shape) == tuple(want[2].count.shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mctx_and_tree_shardings_match_reference(multi_pod):
    from jax.sharding import AbstractMesh
    from repro.models import params as jax_params
    from repro.models.context import MCtx as JaxMCtx
    from repro.models.sharding import param_shardings as jax_shardings
    from repro.models.transformer import model_specs as jax_model_specs
    from repro_torch.launch.dryrun import fake_world as init
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import params
    from repro_torch.models.context import MCtx
    from repro_torch.models.sharding import param_shardings
    from repro_torch.models.transformer import model_specs
    assert not dist.is_initialized()
    init(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        jmesh = AbstractMesh(tuple(mesh.shape), tuple(mesh.mesh_dim_names))
        for manual_pod in (False, True):
            m = MCtx(ParallelConfig(), torch.device("cpu"), mesh=mesh,
                     manual_pod=manual_pod)
            jm = JaxMCtx(jmesh, JaxParallelConfig(), manual_pod=manual_pod)
            assert m.rules == jm.rules
            assert (m.batch_axes, m.data_size, m.model_size) == (
                jm.batch_axes, jm.data_size, jm.model_size)
        assert (m.pod_group is not None) == multi_pod
        cfg = get_config("mixtral-8x22b")
        jcfg = jax_get_config("mixtral-8x22b")
        specs, jspecs = model_specs(cfg, mesh), jax_model_specs(jcfg, jmesh)
        assert params.param_bytes(specs) == jax_params.param_bytes(jspecs)
        got = param_shardings(mesh, m.rules, params.param_axes(specs),
                              params.map_specs(lambda s: s.shape, specs))
        want = jax_shardings(jmesh, jm.rules, jax_params.param_axes(jspecs),
                             jspecs)
        flat_got = dict(params.tree_flatten(got))
        for path, w in params.tree_flatten(jax.tree.map(
                lambda x: x.spec, want,
                is_leaf=lambda x: hasattr(x, "spec"))):
            assert flat_got[path].spec == tuple(w), path
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# lower_cell, in its own process
# --------------------------------------------------------------------------

_LOWER = r"""
import dataclasses, json, sys
from repro_torch.launch import dryrun
dryrun.fake_world(4)
from repro_torch.config.base import get_config
cells = [(arch, experts, shape, kernel) for arch, experts in (
             ("yi-9b", None), ("mixtral-8x22b", 2), ("deepseek-v3-671b", None),
             ("zamba2-7b", None), ("xlstm-350m", None), ("whisper-small", None))
         for shape in sys.argv[1].split(",") for kernel in ("eager",)]
cells = [c for c in cells if c[0] in sys.argv[2].split(",")]
cells += [(a, None, "long_500k", "eager") for a in sys.argv[3].split(",") if a]
if "whisper-small" in sys.argv[2]:
    cells.append(("whisper-small", None, "prefill_32k", "kernel"))
out = {}
for arch, experts, shape, kernel in cells:
    cfg = get_config(arch).reduced()
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    B, S = (1, 64) if shape == "long_500k" else (4, 32)
    rec = dryrun.lower_cell(arch, shape, False, cfg=cfg, mesh_shape=(2, 2),
                            batch=B, seq=S, device_type="cpu",
                            attention_kernel=kernel)
    out[f"{arch}/{shape}/{kernel}"] = {k: rec.get(k) for k in (
        "status", "error", "mesh", "chips", "roofline", "hlo_walk",
        "memory_analysis", "moe_bodies", "placement")}
print(json.dumps(out))
"""

SHAPES3 = "train_4k,prefill_32k,decode_32k"


def _lower(archs: str, long: str = "") -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _LOWER, SHAPES3, archs, long],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for cell, rec in out.items():
        assert rec["status"] == "ok", (cell, rec["error"])
        assert rec["chips"] == 4 and rec["mesh"] == "2x2"
        roof = rec["roofline"]
        assert roof["flops"] > 0 and roof["hbm_bytes"] > 0
        assert roof["bottleneck"] in ("compute", "memory", "collective")
        assert set(roof) == set(jax_analysis.Roofline.build(
            arch="a", shape="s", mesh="m", flops=1.0, hbm_bytes=1.0,
            collective_bytes=1.0, model_flops=1.0).to_json())
        assert rec["hlo_walk"]["collective_bytes"] > 0
        assert rec["memory_analysis"]["peak_size_in_bytes"] >= \
            rec["memory_analysis"]["argument_size_in_bytes"] > 0
    return out


def test_lower_cell_reduced_every_shape_kind():
    out = _lower("yi-9b,mixtral-8x22b")
    assert len(out) == 6
    assert out["mixtral-8x22b/prefill_32k/eager"]["moe_bodies"]["tp"] > 0
    assert "master" in out["yi-9b/train_4k/eager"]["placement"]["kinds"]


def test_lower_cell_reduced_mla_and_encdec():
    """deepseek-v3 (MLA, the MoE EP body with its 4 experts over 4 ranks)
    and whisper (its encoder through K1's op on the fake mesh too)."""
    out = _lower("deepseek-v3-671b,whisper-small")
    assert len(out) == 7
    assert out["deepseek-v3-671b/prefill_32k/eager"]["moe_bodies"]["ep"] > 0
    kern = out["whisper-small/prefill_32k/kernel"]["hlo_walk"]
    eager = out["whisper-small/prefill_32k/eager"]["hlo_walk"]
    assert kern["flops"] > 0 and kern["bytes"] < eager["bytes"]


def test_lower_cell_reduced_recurrent_with_long_500k():
    """zamba2 and xlstm in every shape kind and at long_500k (a
    sequence-sharded cache over both mesh axes)."""
    out = _lower("zamba2-7b,xlstm-350m", "zamba2-7b,xlstm-350m")
    assert len(out) == 8
    for arch in ("zamba2-7b", "xlstm-350m"):
        place = out[f"{arch}/long_500k/eager"]["placement"]
        assert place["seq_sharded_cache"] is True


# --------------------------------------------------------------------------
# The roofline table
# --------------------------------------------------------------------------

_RECORDS = r"""
import json, sys
from pathlib import Path
from repro_torch.launch import dryrun
dryrun.fake_world(4)
from repro_torch.config.base import get_config
out = Path(sys.argv[1])
for arch, shape in (("yi-9b", "decode_32k"), ("yi-9b", "long_500k"),
                    ("xlstm-350m", "prefill_32k")):
    rec = dryrun.lower_cell(arch, shape, False, cfg=get_config(arch).reduced(),
                            mesh_shape=(2, 2), batch=4, seq=32,
                            device_type="cpu")
    text = json.dumps(rec, default=str)
    (out / f"{arch}_{shape}_2x2.json").write_text(text)
    (out / f"{arch}_{shape}_2x2_smoke.json").write_text(text)   # tagged
"""


def test_roofline_table_matches_reference(tmp_path, capsys):
    """The port's table over reduced records equals the reference's
    ``benchmarks/roofline_table.py`` over the same records (its "compile
    s" column fed the trace seconds); tagged records stay out."""
    import importlib.util
    from repro_torch.roofline import table
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _RECORDS, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    spec = importlib.util.spec_from_file_location(
        "ref_roofline_table", ROOT / "benchmarks" / "roofline_table.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    recs = table.load("2x2", tmp_path)
    assert [(r["arch"], r["shape"], r["status"]) for r in recs] == [
        ("xlstm-350m", "prefill_32k", "ok"), ("yi-9b", "decode_32k", "ok"),
        ("yi-9b", "long_500k", "skip(full-attn)")]
    ref.load = lambda mesh: [dict(r, compile_s=r.get("lower_s"))
                             for r in recs]
    assert table.table("2x2", tmp_path) == ref.table("2x2")
    assert table.dryrun_table("2x2", tmp_path) == ref.dryrun_table(
        "2x2").replace("| compile s |", "| trace s |")
    table.main(["--mesh", "2x2", "--dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "### Roofline — mesh 2x2" in printed
    assert printed.count("| yi-9b | decode_32k |") == 2
