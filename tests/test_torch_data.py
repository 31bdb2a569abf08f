"""repro_torch synthetic data vs the reference's: the token stream is bit
for bit the reference's, and the prefetch loader yields it in order."""

import numpy as np
import pytest

from repro.config.base import ShapeConfig as JaxShapeConfig
from repro.config.base import get_config as jax_get_config
from repro.data.synthetic import synthetic_batch as jax_synthetic_batch
from repro_torch.config.base import ShapeConfig, get_config
from repro_torch.data.synthetic import PrefetchLoader, synthetic_batch


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("seq,batch", [(32, 2), (128, 8), (7, 3)])
def test_synthetic_batch_bit_equal_to_reference(reduced, seq, batch):
    cfg, jcfg = get_config("yi-9b"), jax_get_config("yi-9b")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for step, seed in ((0, 0), (3, 0), (4, 7), (1000, 123)):
        got = synthetic_batch(cfg, ShapeConfig("t", seq, batch, "train"),
                              step, seed)
        want = jax_synthetic_batch(jcfg, JaxShapeConfig("t", seq, batch,
                                                        "train"), step, seed)
        assert got.keys() == want.keys()
        for k in want:
            w = np.asarray(want[k])
            assert got[k].numpy().dtype == w.dtype == np.int32
            np.testing.assert_array_equal(got[k].numpy(), w)


def test_synthetic_batch_deterministic():
    cfg = get_config("yi-9b").reduced()
    shape = ShapeConfig("t", 32, 2, "train")
    a = synthetic_batch(cfg, shape, step=3)
    b = synthetic_batch(cfg, shape, step=3)
    c = synthetic_batch(cfg, shape, step=4)
    assert bool((a["tokens"] == b["tokens"]).all())
    assert not bool((a["tokens"] == c["tokens"]).all())
    assert a["labels"].shape == a["tokens"].shape
    # labels are the stream shifted by one
    assert bool((a["labels"][:, :-1] == a["tokens"][:, 1:]).all())


def test_prefetch_loader_yields_the_stream_in_order():
    cfg = get_config("yi-9b").reduced()
    shape = ShapeConfig("t", 32, 2, "train")
    loader = PrefetchLoader(cfg, shape, start_step=5, seed=1, device="cpu")
    try:
        for want_step in (5, 6, 7):
            step, batch = next(loader)
            assert step == want_step
            ref = synthetic_batch(cfg, shape, want_step, 1)
            for k in ref:
                assert batch[k].device.type == "cpu"
                assert bool((batch[k] == ref[k]).all())
    finally:
        loader.close()
    assert not loader._thread.is_alive()
