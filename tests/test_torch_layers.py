"""repro_torch layer primitives vs the reference's, fp32, same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.models import attention, layers

ATOL = 1e-5


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=atol,
                               atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_rmsnorm(rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    _close(layers.rmsnorm(_t(x), _t(w), 1e-6),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(rng, theta):
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(100, 107), (2, 7)).astype(np.int32)
    _close(layers.apply_rope(_t(x), _t(pos).long(), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


def test_mlp_apply(rng):
    d, f = 64, 128
    p = {k: rng.normal(size=s).astype(np.float32) / np.sqrt(s[0])
         for k, s in (("w_gate", (d, f)), ("w_up", (d, f)),
                      ("w_down", (f, d)))}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    _close(layers.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x)),
           jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x)))


@pytest.mark.parametrize("tied", [False, True])
def test_embed_unembed(rng, tied):
    V, d = 256, 64
    p = {"tok": rng.normal(size=(V, d)).astype(np.float32) * 0.02,
         "out": rng.normal(size=(d, V)).astype(np.float32) / 8}
    toks = rng.integers(0, V, (2, 9)).astype(np.int32)
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = layers.embed_tokens(tp, _t(toks).long(), torch.float32)
    jx = jlayers.embed_tokens(jp, jnp.asarray(toks), jnp.float32)
    _close(x, jx)
    _close(layers.unembed(tp, x, tied), jlayers.unembed(jp, jx, tied))


@pytest.mark.parametrize("Sq,q_chunk,causal,window,q_offset", [
    (32, 8, True, 0, 0),        # several chunks
    (32, 512, True, 0, 0),      # one chunk
    (30, 8, True, 0, 0),        # Sq not a multiple of the chunk
    (32, 8, False, 0, 0),       # bidirectional
    (64, 8, True, 16, 0),       # sliding window slices the KV
    (16, 8, True, 0, 16),       # chunked prefill against a longer KV
])
def test_chunked_attention(rng, Sq, q_chunk, causal, window, q_offset):
    B, Hq, Hkv, dh = 2, 4, 2, 16
    Skv = Sq + q_offset
    q = rng.normal(size=(B, Sq, Hq, dh)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, dh)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk,
              q_offset=q_offset)
    _close(attention.chunked_attention(_t(q), _t(k), _t(v), **kw),
           jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **kw))


@pytest.mark.parametrize("batched_mask", [False, True])
def test_decode_attention(rng, batched_mask):
    B, S, Hq, Hkv, dh = 2, 24, 4, 2, 16
    q = rng.normal(size=(B, 1, Hq, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, dh)).astype(np.float32)
    valid = np.arange(S) <= 13
    if batched_mask:
        valid = np.stack([valid, np.arange(S) <= 20])
    _close(attention.decode_attention(_t(q), _t(k), _t(v), _t(valid)),
           jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(valid)))
