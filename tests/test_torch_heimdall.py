"""repro_torch.heimdall's micro, app and calibration families vs the
reference's, on the CPU.

The micro and app rows are timings, so the two packages give other
numbers; what must agree is the rows themselves: each function's row names
in order, and in each row the derived metric's keys and its non-numeric
values (``mode=copy-then-compute``, the cost model's bound). The cost
model's curve (``app_offload_model/*``) is computed, not timed, so those
rows must be equal whole. The benchmarks run at small sizes here, the
same on both sides; on the card ``chip_smoke.py`` runs them at the
reference's defaults.

The lock-free map hashes keys with a uint32 product; the port computes it
in int64 and masks to 32 bits. Its 512 keys over 4096 slots collide, and
a scatter with repeated indices has no defined winner in either framework,
so the map round is compared on the set of slots and on the rows whose
slot only one key wrote.

The calibration family is emulated except ``calibration_torch_probe`` (the
reference's ``calibration_jax_probe``), whose fitted constants are real
timings: its rows are compared on names, keys and provenance only.
"""

import inspect
import re

import numpy as np
import pytest
import torch

from repro_torch.heimdall import apps, calibration, micro
from repro_torch.heimdall import harness

SMALL_MICRO = {
    "micro_latency": dict(n_elems=1024, chase_len=64),
    "micro_bandwidth_scaling": dict(mb=1),
    "micro_loaded_latency": dict(n_elems=1024, mb=1),
    "micro_weighted_interleave": dict(pages=8, page_kb=4),
    "micro_writeback": dict(sizes_kb=(4, 64)),
    "micro_atomics": dict(n_updates=256),
    "micro_cache_heatmap": {},
    "micro_prefetch": dict(mb=1),
    "micro_copy_engine": dict(sizes_kb=(4, 64)),
    "micro_lfds": dict(n_ops=64, n_elems=256, dim=8),
}
SMALL_APPS = {
    "app_llm_inference": dict(steps=2, batch=2, prompt=8),
    "app_offload_sweep": dict(steps=2, batch=1),
    "app_vectordb": dict(n_vecs=256, dim=32, k=4, queries=4),
    "app_kv_workload": dict(n_keys=256, dim=16, ops=64),
}
NUM = re.compile(r"^-?[0-9.]+(e[-+]?[0-9]+)?(x|/[0-9]+)?$")


def _shape(row: str):
    """A row's name and its derived metric with every number blanked."""
    name, _, derived = row.split(",", 2)
    parts = []
    for item in derived.split(";"):
        key, eq, val = item.partition("=")
        parts.append((key, "#" if NUM.match(val) else val) if eq
                     else ("#" if NUM.match(key) else key))
    return name, parts


def _rows(fn, **kw):
    return [r.csv() for r in fn(**kw)]


def test_family_lists_match_reference():
    from repro.heimdall import apps as ref_apps
    from repro.heimdall import calibration as ref_cal
    from repro.heimdall import micro as ref_micro
    assert [f.__name__ for f in micro.ALL_MICRO] == \
        [f.__name__ for f in ref_micro.ALL_MICRO] == list(SMALL_MICRO)
    assert [f.__name__ for f in apps.ALL_APPS] == \
        [f.__name__ for f in ref_apps.ALL_APPS] == list(SMALL_APPS)
    assert [f.__name__.replace("torch", "jax")
            for f in calibration.ALL_CALIBRATION] == \
        [f.__name__ for f in ref_cal.ALL_CALIBRATION]


@pytest.mark.parametrize("name", list(SMALL_MICRO))
def test_micro_rows_match_reference(name):
    from repro.heimdall import micro as ref
    kw = SMALL_MICRO[name]
    want = _rows(getattr(ref, name), **kw)
    got = _rows(getattr(micro, name), device="cpu", **kw)
    assert [_shape(r) for r in got] == [_shape(r) for r in want]
    assert all(float(r.split(",")[1]) > 0 for r in got)


@pytest.mark.parametrize("name", list(SMALL_APPS))
def test_app_rows_match_reference(name):
    from repro.heimdall import apps as ref
    kw = SMALL_APPS[name]
    want = _rows(getattr(ref, name), **kw)
    got = _rows(getattr(apps, name), device="cpu", **kw)
    assert [_shape(r) for r in got] == [_shape(r) for r in want]
    computed = [r for r in want if r.startswith("app_offload_model/")]
    assert [r for r in got if r.startswith("app_offload_model/")] == computed


@pytest.mark.parametrize("fn", [f for f in micro.ALL_MICRO + apps.ALL_APPS])
def test_benchmarks_run_on_cuda_by_default(monkeypatch, fn):
    assert inspect.signature(fn).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        fn()


# ---------------------------------------------------------------------------
# the lock-free structures and the atomics' inputs
# ---------------------------------------------------------------------------


def _ref_rounds():
    """The reference's ``micro_lfds`` loop bodies, jitted as it jits them
    (they are local to the function there)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def queue_round(buf, head, vals):
        n = vals.shape[0]
        idx = (head + jnp.arange(n)) % buf.shape[0]
        buf = buf.at[idx].set(vals)
        out = buf[(head + jnp.arange(n)) % buf.shape[0]]
        return buf, head + n, out.sum()

    @jax.jit
    def map_round(table, keys, vals):
        slots = ((keys * jnp.uint32(2654435761))
                 % jnp.uint32(table.shape[0])).astype(jnp.int32)
        table = table.at[slots].set(vals)
        got = table[slots]
        return table, got.sum(), slots
    return queue_round, map_round


@pytest.mark.parametrize("n_ops,n_elems,head", [(512, 4096, 0),
                                                (64, 48, 30)])
def test_lfds_queue_round_matches_reference(n_ops, n_elems, head):
    import jax.numpy as jnp
    queue_round, _ = _ref_rounds()
    vals, _ = micro.lfds_inputs(n_ops, 16)
    buf0 = np.random.default_rng(1).normal(size=(n_elems, 16)) \
        .astype(np.float32)
    wb, wh, ws = queue_round(jnp.asarray(buf0), jnp.int32(head),
                             jnp.asarray(vals))
    gb, gh, gs = micro.lfds_queue_round(torch.from_numpy(buf0), head,
                                        torch.from_numpy(vals))
    assert np.array_equal(gb.numpy(), np.asarray(wb)) and gh == int(wh)
    assert np.isclose(float(gs), float(ws), rtol=1e-5)


def test_lfds_map_round_matches_reference_where_defined():
    import jax.numpy as jnp
    _, map_round = _ref_rounds()
    vals, keys = micro.lfds_inputs(512, 16)
    table0 = np.zeros((4096, 16), np.float32)
    wt, _, wslots = map_round(jnp.asarray(table0),
                              jnp.asarray(keys, jnp.uint32),
                              jnp.asarray(vals))
    wt, wslots = np.asarray(wt), np.asarray(wslots)
    slots = micro.lfds_slots(torch.from_numpy(keys), 4096)
    assert np.array_equal(slots.numpy(), wslots)
    gt, _ = micro.lfds_map_round(torch.from_numpy(table0),
                                 torch.from_numpy(keys),
                                 torch.from_numpy(vals))
    gt = gt.numpy()
    used, counts = np.unique(wslots, return_counts=True)
    assert counts.max() > 1                   # the keys do collide
    assert np.array_equal(np.flatnonzero(np.abs(gt).sum(1)),
                          np.flatnonzero(np.abs(wt).sum(1)))
    unique = used[counts == 1]
    assert np.array_equal(gt[unique], wt[unique])
    for s in used[counts > 1]:               # a colliding slot holds one
        rows = vals[wslots == s]              # of its keys' rows
        assert any(np.array_equal(gt[s], r) for r in rows)


def test_lfds_inputs_and_atomics_inputs_follow_the_reference_draws():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(512, 16))
    keys = rng.integers(0, 1 << 30, 512)
    got_vals, got_keys = micro.lfds_inputs()
    assert np.array_equal(got_vals, vals.astype(np.float32))
    assert np.array_equal(got_keys, keys)
    rng = np.random.default_rng(0)
    spread = rng.integers(0, 1 << 14, 1 << 14).astype(np.int32)
    spread_host = rng.integers(0, 1 << 14, 1 << 14).astype(np.int32)
    got = micro.atomics_inputs()
    assert [(t, c) for t, c, _ in got] == [
        ("hbm", False), ("hbm", True), ("host", False), ("host", True)]
    assert np.array_equal(got[0][2], spread)
    assert np.array_equal(got[2][2], spread_host)
    assert not got[1][2].any() and not got[3][2].any()


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


def test_copy_time_stats_times_host_copies_on_the_cpu():
    x = torch.arange(1 << 16, dtype=torch.float32)
    t = harness.copy_time_stats(x, "cpu", warmup=1, iters=5)
    assert len(t.times) == 5 and t.median > 0 and t.dispersion >= 0


def test_on_streams_runs_in_order_on_the_cpu():
    seen = []
    streams = harness.side_streams(3, "cpu")
    assert streams == [None] * 3
    out = harness.on_streams([lambda i=i: seen.append(i) or i
                              for i in range(3)], streams)
    assert out == [0, 1, 2] and seen == [0, 1, 2]


def test_place_moves_bytes_for_every_tier():
    """Placing on the CPU copies into host memory; the calibration probe
    then copies out of it again (a device tensor placed on its own device
    is itself, which would time nothing)."""
    x = torch.arange(8, dtype=torch.float32)
    assert harness.place(x, "hbm", "cpu") is x
    h = harness.place(x, "host", "cpu")
    assert h is not x and torch.equal(h, x)
    with pytest.raises(ValueError, match="unknown tier"):
        harness.place(x, "pool", "cpu")


# ---------------------------------------------------------------------------
# the calibration family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [f.__name__ for f in
                                  calibration.ALL_CALIBRATION[:-1]])
def test_calibration_rows_match_reference(name):
    from repro.heimdall import calibration as ref
    assert _rows(getattr(calibration, name)) == _rows(getattr(ref, name))


def test_calibration_summary_matches_reference():
    from repro.heimdall import calibration as ref
    assert calibration.calibration_summary() == ref.calibration_summary()
    assert (calibration.FIT_BW_ERR_MAX, calibration.VALIDATION_ERR_MAX,
            calibration.TRUTH_KW) == (ref.FIT_BW_ERR_MAX,
                                      ref.VALIDATION_ERR_MAX, ref.TRUTH_KW)


def test_calibration_torch_probe_rows_match_the_jax_probe_rows():
    """Real timings: names, keys and which routes were measured."""
    from repro.heimdall import calibration as ref
    want = _rows(ref.calibration_jax_probe)
    got = _rows(calibration.calibration_torch_probe, device="cpu")
    assert [_shape(r.replace("calibration_torch/", "calibration_jax/")
                   .replace("source=torch", "source=jax")) for r in got] \
        == [_shape(r) for r in want]
    assert sum("source=torch" in r for r in got) == 2
