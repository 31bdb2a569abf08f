"""The port's counterpart of ``tests/test_configs.py`` over all ten
architectures, on the CPU (the configs themselves are held in
``tests/test_torch_decode_parity.py``): the registry and shapes equal the
reference's, ``make_batch`` and ``synthetic_batch`` equal the reference's
draws (bf16 bit for bit, compared as int16 views), one reduced forward and
loss, one reduced prefill and decode step; and the serving engine's
refusal of an encoder-decoder config, where the reference's engine fails
on a missing ``frames``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.config.base import SHAPES as JAX_SHAPES
from repro.config.base import ShapeConfig as JaxShapeConfig
from repro.config.base import get_config as jax_get_config
from repro.config.base import list_archs as jax_list_archs
from repro.data.synthetic import synthetic_batch as jax_synthetic_batch
from repro.launch.inputs import make_batch as jax_make_batch
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import ServeEngine as JaxServeEngine
from repro_torch.config.base import (SHAPES, ParallelConfig, ShapeConfig,
                                     get_config, get_shape, list_archs)
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.launch.inputs import make_batch
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeEngine
from repro_torch.models.model import Model
from repro_torch.models.transformer import loss_fn

ARCHS = jax_list_archs()


def _numpy(a) -> np.ndarray:
    """A tensor or jax array as numpy; bf16 as its int16 bits."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_batches_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        g, w = _numpy(got[k]), _numpy(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_all_archs_registered_as_in_reference():
    assert list_archs() == ARCHS
    assert len(ARCHS) == 10


def test_shapes_copy_matches_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for name in SHAPES:
        assert dataclasses.asdict(get_shape(name).reduced()) == \
            dataclasses.asdict(JAX_SHAPES[name].reduced())


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_matches_reference(arch, shape):
    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    for rng in (None, 7):
        got = make_batch(cfg, get_shape(shape).reduced(), rng, device="cpu")
        want = jax_make_batch(jcfg, JAX_SHAPES[shape].reduced(), rng)
        _assert_batches_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batch_matches_reference(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    for step, seed in ((0, 0), (5, 3)):
        got = synthetic_batch(cfg, ShapeConfig("t", 24, 3, "train"), step,
                              seed)
        want = jax_synthetic_batch(jcfg, JaxShapeConfig("t", 24, 3, "train"),
                                   step, seed)
        _assert_batches_equal(got, want)


def test_make_batch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        make_batch(get_config("whisper-small").reduced(),
                   get_shape("train_4k").reduced())


def _model(arch: str) -> tuple:
    cfg = get_config(arch).reduced()
    m = Model.create(cfg, ParallelConfig(remat="none"), device="cpu")
    return cfg, m, m.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_smoke_forward_and_loss(arch):
    """One forward + loss on a reduced config: shapes + no NaNs."""
    cfg, m, params = _model(arch)
    batch = make_batch(cfg, get_shape("train_4k").reduced(), device="cpu")
    with torch.inference_mode():
        loss, parts = loss_fn(params, cfg, m.mctx, batch)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss))
    assert 2.0 < float(loss) < 12.0     # ~ln(vocab) at random init


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_smoke_prefill_decode(arch):
    cfg, m, params = _model(arch)
    shape = get_shape("prefill_32k").reduced()
    # one slot past the prompt for the new token (the reference's test
    # decodes into a prompt-length cache, where jax clamps the write into
    # the last slot; the port's in-place write refuses an index past it)
    with torch.inference_mode():
        out, cache = m.prefill(params, make_batch(cfg, shape, device="cpu"),
                               max_len=shape.seq_len + 1)
        tok = torch.ones((shape.global_batch, 1), dtype=torch.long)
        logits, cache = m.decode(params, cache, tok, shape.seq_len)
    assert tuple(logits.shape) == (shape.global_batch, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


def test_serve_engine_refuses_whisper_where_reference_fails():
    """The reference's engine builds for whisper and fails at prefill,
    which reads the batch's frames; the port's refuses up front, and so
    does its serve CLI."""
    jcfg = jax_get_config("whisper-small").reduced(dtype="float32")
    prompt = np.arange(5, dtype=np.int32)
    with pytest.raises(KeyError, match="frames"):
        JaxServeEngine(jcfg).serve([JaxRequest(0, prompt, 2)])
    with pytest.raises(ValueError, match="encoder-decoder"):
        ServeEngine(get_config("whisper-small").reduced(), device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--arch", "whisper-small", "--reduced", "--device",
                    "cpu"])
