"""The mesh path (repro_torch.launch.mesh, models.sharding, models.tp) vs
the reference.

The sharding rules and every leaf's spec equal the reference's exactly.
Every arch on a one-rank mesh equals the plain path bit for bit. A sharded
model over four ``gloo`` processes (a 2x2 or 1x4 (data, model) mesh on the
CPU) equals the reference's single-device model on the same weights, at
the fp32 tolerances of ``tests/test_torch_model.py`` (prefill 2e-4, decode
5e-4) and ``tests/test_torch_zoo_train.py`` (loss and gradients 2e-4):
reduced yi-9b prefill, decode, ``Model.loss`` and its gradients with FSDP
and sequence parallelism on and off and with 2-D serving weights; a
reduced MoE with 2 experts (the tensor-parallel body: 2 experts < 4 ranks)
and with 4 (the expert-parallel body); deepseek-v3's MLA under both
bodies; zamba2, xlstm and whisper; and the layouts of their full widths
that an even 2x2 split cannot show (``SCENARIOS``). The four processes are
spawned once for the file.

The EP body routes each rank's tokens on their own, as the reference's
mesh does, so its load-balancing loss is a mean over ranks, not the
single-device one: for 4 experts the cross-entropy is compared. With 2
experts and top-2 routing every token reaches both experts and the aux
loss is exactly 1 on both sides.
"""

import dataclasses
import os
import pickle
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.config.base import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import sharding as jax_sharding
from repro.models.model import Model as JaxModel
from repro.models.transformer import loss_fn as jax_loss_fn
from repro.models.transformer import model_specs as jax_model_specs
from repro_torch.config.base import ParallelConfig, get_config, list_archs
from repro_torch.models import sharding
from repro_torch.models.transformer import model_specs

PREFILL_TOL, DECODE_TOL, GRAD_TOL = 2e-4, 5e-4, 2e-4
B, S, STEPS = 4, 16, 3
# decode caches' length: a multiple of every mesh's model axis, so the
# rules shard their sequence and decode takes the flash-decoding combine
MAX_LEN = S + 4


class _AbstractMesh:
    """A mesh by its axis names and sizes: what the reference's rules,
    ``spec_for`` and ``use_ep`` read (``axis_names``, ``shape``)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


# --------------------------------------------------------------------------
# Rules and specs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("seq_parallel", [True, False])
@pytest.mark.parametrize("serve_2d", [True, False])
@pytest.mark.parametrize("seq_sharded_cache", [True, False])
def test_logical_rules_match_reference(mesh, fsdp, seq_parallel, serve_2d,
                                       seq_sharded_cache):
    kw = dict(fsdp=fsdp, seq_parallel=seq_parallel,
              serve_2d_weights=serve_2d)
    want = jax_sharding.logical_rules(_AbstractMesh(MESHES[mesh]),
                                      JaxParallelConfig(**kw),
                                      seq_sharded_cache)
    got = sharding.logical_rules(MESHES[mesh], ParallelConfig(**kw),
                                 seq_sharded_cache)
    assert got == want


def _leaves(tree, prefix=()):
    if hasattr(tree, "axes"):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], prefix + (k,))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_spec_for_matches_reference_on_every_leaf(arch, mesh):
    sizes = MESHES[mesh]
    jmesh = _AbstractMesh(sizes)
    for fsdp in (True, False):
        jrules = jax_sharding.logical_rules(jmesh, JaxParallelConfig(
            fsdp=fsdp))
        rules = sharding.logical_rules(sizes, ParallelConfig(fsdp=fsdp))
        want = dict(_leaves(jax_model_specs(jax_get_config(arch), jmesh)))
        got = dict(_leaves(model_specs(get_config(arch), sizes)))
        assert got.keys() == want.keys()
        for path, w in want.items():
            g = got[path]
            assert (g.shape, g.axes) == (w.shape, w.axes), path
            jspec = jax_sharding.spec_for(w.axes, jrules, w.shape, jmesh)
            spec = sharding.spec_for(g.axes, rules, g.shape, sizes)
            assert spec == tuple(jspec), (path, spec, jspec)
            # the placements shard exactly the dims the spec names
            pl = sharding.placements_of(spec, sizes)
            for axis, p in zip(sizes, pl):
                dims = [i for i, part in enumerate(spec)
                        if axis in sharding.spec_axes(part)]
                assert (p.dim if p.is_shard() else None) == (
                    dims[0] if dims else None), (path, axis)


def test_constrain_is_identity_on_plain_tensors():
    x = torch.ones(4, 8)
    rules = sharding.logical_rules(MESHES["16x16"], ParallelConfig())
    assert sharding.constrain(x, None, rules, ("act_batch", None)) is x


def _one_rank_batch(cfg, gen):
    if cfg.encoder_decoder:
        return {"frames": torch.randn(2, 8, cfg.d_model, generator=gen)}
    if cfg.frontend == "vision":
        return {"embeds": torch.randn(2, 8, cfg.d_model, generator=gen)}
    return {"tokens": torch.randint(0, cfg.vocab_size, (2, 8),
                                    generator=gen)}


@pytest.mark.parametrize("arch", list_archs())
def test_one_rank_mesh_equals_plain_path(arch):
    """Every arch runs on a mesh: on one rank its prefill and decode steps
    are the plain path's, bit for bit. The mesh bodies keep the capacity
    MoE layer, so the plain path they are held to is the model's own
    context (``dropless`` off), not the dropless serving roles'."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import local_process_group, make_host_mesh
    from repro_torch.models.decode import decode_step, prefill
    from repro_torch.models.model import Model
    cfg = get_config(arch).reduced(dtype="float32")
    plain = Model.create(cfg, device="cpu")
    params = plain.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = _one_rank_batch(cfg, gen)
    start = 0 if cfg.encoder_decoder else 8

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    with local_process_group("cpu"):
        m = Model.create(cfg, ParallelConfig(), device="cpu",
                         mesh=make_host_mesh(device_type="cpu"))
        m.set_params(params)
        with torch.no_grad():
            want, wc = prefill(params, cfg, plain.mctx, batch, 12)
            got, gc = m.prefill(m.params, batch, 12)
            assert torch.equal(whole(got), want)
            for i in range(3):
                tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen)
                want, wc = decode_step(params, cfg, plain.mctx, wc, tok,
                                       start + i)
                got, gc = m.decode(m.params, gc, tok, start + i)
                assert torch.equal(whole(got), want), f"decode step {i}"


def test_mesh_helpers_on_one_rank():
    from repro_torch.launch import mesh as m
    from repro_torch.runtime.elastic import ElasticDecision, make_elastic_mesh
    assert not dist.is_initialized()
    with m.local_process_group("cpu"):
        host = m.make_host_mesh(device_type="cpu")
        assert m.mesh_axis_names(host) == ("data", "model")
        assert m.mesh_shape(host) == {"data": 1, "model": 1}
        assert m.data_axes(host) == ("data",) and m.num_chips(host) == 1
        with pytest.raises(ValueError, match="needs 4 devices"):
            m.make_mesh((2, 2), ("data", "model"), "cpu")
        em = make_elastic_mesh(ElasticDecision((1, 1), 8, ""), "cpu")
        assert m.mesh_shape(em) == {"data": 1, "model": 1}
    assert not dist.is_initialized()


def test_one_rank_mesh_wraps_plain_leaves_without_copy():
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import local_process_group, make_host_mesh
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_flatten
    cfg = get_config("yi-9b").reduced(dtype="float32")
    plain = Model.create(cfg, device="cpu")
    params = plain.init(torch.Generator().manual_seed(0))
    with local_process_group("cpu"):
        mesh = make_host_mesh(device_type="cpu")
        m = Model.create(cfg, ParallelConfig(), device="cpu", mesh=mesh)
        m.set_params(params)
        placed = dict(tree_flatten(m.params))
        for path, leaf in tree_flatten(params):
            assert isinstance(placed[path], DTensor)
            assert placed[path].to_local().data_ptr() == leaf.data_ptr()
        toks = torch.randint(0, cfg.vocab_size, (2, 8),
                             generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            want, _ = plain.prefill(params, {"tokens": toks})
            got, _ = m.prefill(m.params, {"tokens": toks})
        assert torch.equal(got.full_tensor(), want)


# --------------------------------------------------------------------------
# Sharded forward, decode, loss and gradients over 4 gloo processes
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sc:
    """A sharded scenario: the arch, its MoE experts (None: the reduced
    config's), FSDP, sequence parallelism, what of the loss is compared
    ("grads": loss and every gradient; "ce": the cross-entropy), 2-D
    serving weights, the (data, model) mesh and overrides of the reduced
    config."""
    arch: str
    experts: int | None = None
    fsdp: bool = True
    sp: bool = True
    loss: str = "grads"
    s2d: bool = False
    mesh: tuple = (2, 2)
    over: tuple = ()


SCENARIOS = {
    "dense_fsdp_sp": Sc("yi-9b"),
    "dense_tp": Sc("yi-9b", fsdp=False, sp=False),
    "dense_serve_2d": Sc("yi-9b", sp=False, s2d=True),
    "moe_tp_body": Sc("mixtral-8x22b", 2),
    "moe_ep_body": Sc("mixtral-8x22b", 4, sp=False, loss="ce"),
    # MLA with the dense/MoE split and a shared expert, under both bodies
    "mla_tp_body": Sc("deepseek-v3-671b", 2),
    "mla_ep_body": Sc("deepseek-v3-671b", 4, fsdp=False, sp=False,
                      loss="ce"),
    # Mamba2 groups with the shared attention block; the mLSTM/sLSTM pair;
    # the encoder-decoder: heads and vocabulary split evenly on 2x2
    "zamba2": Sc("zamba2-7b"),
    "xlstm": Sc("xlstm-350m"),
    "whisper": Sc("whisper-small", sp=False),
    # the full-width traps on a (1, 4) mesh: Mamba2's inner norm over 4
    # ranks (one SSD head each); an xLSTM whose 64-wide heads are split 4
    # ways (16 columns a rank, gates whole); a whisper whose 3 heads and
    # 250-token vocabulary 4 does not divide (sequence-parallel, so its
    # self and cross caches are sequence-sharded)
    "zamba2_norm_1x4": Sc("zamba2-7b", mesh=(1, 4)),
    "xlstm_split_head": Sc("xlstm-350m", mesh=(1, 4),
                           over=(("num_heads", 2), ("head_dim", 64))),
    "whisper_undivided": Sc("whisper-small", mesh=(1, 4),
                            over=(("num_heads", 3), ("num_kv_heads", 3),
                                  ("vocab_size", 250))),
}


def _cfg(get, sc: Sc):
    cfg = get(sc.arch).reduced(dtype="float32", **dict(sc.over))
    if sc.experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=sc.experts))
    return cfg


def _inputs(cfg) -> dict:
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
           "steps": rng.integers(0, cfg.vocab_size,
                                 (STEPS, B, 1)).astype(np.int32)}
    if cfg.encoder_decoder:
        out["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    return out


def _prompt(inp: dict, cfg, conv) -> tuple:
    """(the prefill batch, the first decode position): whisper prefills
    its frames and decodes from position 0."""
    if cfg.encoder_decoder:
        return {"frames": conv(inp["frames"])}, 0
    return {"tokens": conv(inp["tokens"])}, S


def _loss_batch(inp: dict, cfg, conv) -> dict:
    keys = ("tokens", "labels") + (("frames",) if cfg.encoder_decoder
                                   else ())
    return {k: conv(inp[k]) for k in keys}


def _worker(rank: int, port: int, work_dir: str) -> None:
    """One rank of the meshes: every scenario through the port's mesh
    path; rank 0 writes the whole values."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    try:
        from torch.distributed.tensor import DTensor
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import moe
        from repro_torch.models.model import Model
        from repro_torch.models.params import (tree_flatten,
                                               tree_unflatten)
        meshes = {}

        def whole(t):
            t = t.full_tensor() if isinstance(t, DTensor) else t
            return t.detach().numpy()

        def conv(a):
            t = torch.from_numpy(np.array(a))
            return t if t.is_floating_point() else t.long()
        results = {}
        for name, sc in SCENARIOS.items():
            with open(os.path.join(work_dir, f"{name}.pkl"), "rb") as f:
                params_np, inp = pickle.load(f)
            cfg = _cfg(get_config, sc)
            if sc.mesh not in meshes:
                meshes[sc.mesh] = make_mesh(sc.mesh, ("data", "model"),
                                            "cpu")
            model = Model.create(cfg, ParallelConfig(
                fsdp=sc.fsdp, seq_parallel=sc.sp, remat="full",
                serve_2d_weights=sc.s2d), device="cpu",
                mesh=meshes[sc.mesh])
            flat = tree_flatten(params_np)
            model.set_params(tree_unflatten(
                [p for p, _ in flat],
                [torch.from_numpy(np.array(v)) for _, v in flat]))
            moe.BODY_CALLS.update(ep=0, tp=0)
            out = {}
            prompt, start = _prompt(inp, cfg, conv)
            with torch.no_grad():
                logits, cache = model.prefill(model.params, prompt,
                                              MAX_LEN)
                out["prefill"] = whole(logits)
                for i in range(STEPS):
                    logits, cache = model.decode(
                        model.params, cache, conv(inp["steps"][i]),
                        start + i)
                    out[f"decode{i}"] = whole(logits)
            pflat = tree_flatten(model.params)
            leaves = [p.detach().requires_grad_() for _, p in pflat]
            lval, parts = model.loss(
                tree_unflatten([p for p, _ in pflat], leaves),
                _loss_batch(inp, cfg, conv))
            out["loss"], out["ce"] = float(lval), float(parts["ce"])
            if sc.loss == "grads":
                grads = torch.autograd.grad(lval, leaves)
                out["grads"] = {"/".join(p): whole(g) for (p, _), g in
                                zip(pflat, grads)}
            out["bodies"] = dict(moe.BODY_CALLS)
            out["placements"] = {"/".join(p): str(v.placements)
                                 for p, v in pflat}
            results[name] = out
        if rank == 0:
            with open(os.path.join(work_dir, "out.pkl"), "wb") as f:
                pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference(name: str):
    sc = SCENARIOS[name]
    jcfg = _cfg(jax_get_config, sc)
    jm = JaxModel.create(jcfg, jax_host_mesh(),
                         JaxParallelConfig(remat="full"))
    jparams = jm.init(jax.random.key(3))
    inp = _inputs(jcfg)
    out = {}
    prompt, start = _prompt(inp, jcfg, jnp.asarray)
    logits, cache = jm.prefill(jparams, prompt, MAX_LEN)
    out["prefill"] = np.asarray(logits)
    for i in range(STEPS):
        logits, cache = jm.decode(jparams, cache,
                                  jnp.asarray(inp["steps"][i]), start + i)
        out[f"decode{i}"] = np.asarray(logits)
    batch = _loss_batch(inp, jcfg, jnp.asarray)
    (loss, parts), grads = jax.value_and_grad(
        lambda p: jax_loss_fn(p, jcfg, jm.mctx, batch),
        has_aux=True)(jparams)
    out["loss"], out["ce"] = float(loss), float(parts["ce"])
    out["grads"] = {"/".join(p): g for p, g in _leaves_np(
        jax.tree.map(np.asarray, grads))}
    return jax.tree.map(np.asarray, jparams), inp, out


def _leaves_np(tree, prefix=()):
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _leaves_np(tree[k], prefix + (k,))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh4")
    refs = {}
    for name in SCENARIOS:
        params, inp, out = _reference(name)
        refs[name] = out
        with open(work / f"{name}.pkl", "wb") as f:
            pickle.dump((params, inp), f)
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(work)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=420)
    codes = [p.exitcode for p in procs]
    assert codes == [0, 0, 0, 0], codes
    with open(work / "out.pkl", "rb") as f:
        return pickle.load(f), refs


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sharded_prefill_and_decode_match_reference(sharded, name):
    got, want = sharded[0][name], sharded[1][name]
    np.testing.assert_allclose(got["prefill"], want["prefill"],
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)
    for i in range(STEPS):
        np.testing.assert_allclose(got[f"decode{i}"], want[f"decode{i}"],
                                   rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sharded_loss_and_grads_match_reference(sharded, name):
    got, want = sharded[0][name], sharded[1][name]
    assert got["ce"] == pytest.approx(want["ce"], rel=GRAD_TOL)
    if SCENARIOS[name].loss != "grads":
        return
    assert got["loss"] == pytest.approx(want["loss"], rel=GRAD_TOL)
    assert got["grads"].keys() == want["grads"].keys()
    for path, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][path], w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=path)


def test_moe_bodies_and_placements(sharded):
    res = sharded[0]
    assert res["moe_tp_body"]["bodies"]["tp"] > 0
    assert res["moe_tp_body"]["bodies"]["ep"] == 0
    assert res["moe_ep_body"]["bodies"]["ep"] > 0
    assert res["moe_ep_body"]["bodies"]["tp"] == 0
    assert res["dense_tp"]["bodies"] == {"ep": 0, "tp": 0}
    pl = res["dense_fsdp_sp"]["placements"]
    # w_q (L, d, Hq, dh): d over 'data' (FSDP), heads over 'model'
    assert pl["decoder/attn/w_q"] == "(Shard(dim=1), Shard(dim=2))"
    assert res["dense_tp"]["placements"]["decoder/attn/w_q"] == \
        "(Replicate(), Shard(dim=2))"
    # EP experts over (data, model) jointly; TP: the hidden dim on 'model'
    assert res["moe_ep_body"]["placements"]["moe/moe/w_up"] == \
        "(Shard(dim=1), Shard(dim=1))"
    assert res["moe_tp_body"]["placements"]["moe/moe/w_up"] == \
        "(Shard(dim=2), Shard(dim=3))"


def test_mla_recurrent_and_encdec_layouts(sharded):
    """The new archs' scenarios ran the layouts they stand for."""
    res = sharded[0]
    assert res["mla_tp_body"]["bodies"]["tp"] > 0
    assert res["mla_ep_body"]["bodies"]["ep"] > 0
    assert res["mla_ep_body"]["bodies"]["tp"] == 0
    # MLA: up-projections on local heads, down-projections whole on 'model'
    pl = res["mla_tp_body"]["placements"]
    assert pl["dense/attn/w_uq"] == "(Replicate(), Shard(dim=2))"
    assert pl["dense/attn/w_dq"] == "(Shard(dim=1), Replicate())"
    assert pl["moe/moe/shared/w_up"] == "(Shard(dim=1), Shard(dim=2))"
    # xLSTM split heads: 16 of a 64-wide head's columns a rank, gates and
    # recurrent matrices whole
    pl = res["xlstm_split_head"]["placements"]
    assert pl["groups/mlstm/cell/w_q"] == "(Shard(dim=2), Shard(dim=3))"
    assert pl["groups/mlstm/cell/w_i"] == "(Shard(dim=2), Replicate())"
    assert pl["groups/slstm/cell/r_z"] == "(Replicate(), Replicate())"
    # whisper: 3 heads and a 250-token vocabulary stay whole on 'model'
    pl = res["whisper_undivided"]["placements"]
    assert pl["decoder/attn/w_q"] == "(Shard(dim=1), Replicate())"
    assert pl["embed/tok"] == "(Shard(dim=1), Replicate())"
    assert pl["encoder/mlp/w_up"] == "(Shard(dim=1), Shard(dim=2))"
    # Mamba2 over 4 ranks: one SSD head each, the inner norm's weight whole
    pl = res["zamba2_norm_1x4"]["placements"]
    assert pl["groups/mamba/ssm/w_x"] == "(Shard(dim=2), Shard(dim=3))"
    assert pl["groups/mamba/ssm/norm"] == "(Replicate(), Replicate())"
