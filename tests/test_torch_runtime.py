"""repro_torch runtime (supervisor, retry, stragglers) and checkpoints.

Mirrors ``tests/test_runtime.py`` and ``tests/test_checkpoint.py`` for the
port's copies, and holds the port's checkpoints to the reference's on-disk
layout: each package restores what the other saved.
"""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim import adamw
from repro_torch.runtime.fault import (HostFailure, StepSupervisor,
                                       StepTimeout, StragglerStats,
                                       retry_with_checkpoint)


# -- StragglerStats ---------------------------------------------------------


def test_straggler_min_samples_boundary():
    s = StragglerStats(min_samples=10)
    for _ in range(8):
        s.record(0.1)
    s.record(10.0)
    assert not s.inflated
    s.record(0.1)
    assert s.inflated


# -- StepSupervisor ---------------------------------------------------------


def test_supervisor_fake_clock_measures_dt():
    ticks = iter([0.0, 1.5, 10.0, 10.25])
    sup = StepSupervisor(min_timeout=60.0, clock=lambda: next(ticks))
    out, dt = sup.run(lambda: "ok")
    assert out == "ok" and dt == pytest.approx(1.5)
    assert sup.times == [pytest.approx(1.5)]
    _, dt2 = sup.run(lambda: "ok")
    assert dt2 == pytest.approx(0.25)


def test_supervisor_timeout_cancels_cooperative_thunk():
    witnessed = {}

    def thunk(cancel=None):
        cancel.wait(10.0)
        witnessed["cancelled"] = cancel.is_set()

    sup = StepSupervisor(min_timeout=0.1, cancel_grace=2.0)
    with pytest.raises(StepTimeout) as ei:
        sup.run(thunk)
    assert "no step history yet" in str(ei.value)
    assert witnessed.get("cancelled") is True


def test_supervisor_timeout_message_reports_history():
    ticks = iter([0.0, 2.0, 100.0, 200.0])
    sup = StepSupervisor(timeout_factor=1.0, min_timeout=0.05,
                         clock=lambda: next(ticks), cancel_grace=0.0)
    sup.run(lambda: None)
    ev = threading.Event()
    with pytest.raises(StepTimeout) as ei:
        sup.run(ev.wait)
    ev.set()
    assert "trailing median 2.0s over 1 steps" in str(ei.value)


def test_supervisor_without_grace_waits_for_the_thunk():
    """``cancel_grace=None``: the timeout is raised only once the thunk has
    returned, so nothing still writes the state it restores."""
    import time
    finished = threading.Event()

    def thunk():
        time.sleep(0.5)
        finished.set()

    sup = StepSupervisor(min_timeout=0.05, cancel_grace=None)
    with pytest.raises(StepTimeout):
        sup.run(thunk)
    assert finished.is_set()


def test_supervisor_reraises_thunk_error():
    sup = StepSupervisor(min_timeout=5.0)
    with pytest.raises(ZeroDivisionError):
        sup.run(lambda: 1 / 0)
    assert sup.times == []


def test_supervisor_timeout_real_sleep():
    import time
    sup = StepSupervisor(timeout_factor=1.0, min_timeout=0.2)
    with pytest.raises(StepTimeout):
        sup.run(lambda: time.sleep(5))
    out, dt = sup.run(lambda: 42)
    assert out == 42 and dt >= 0


# -- retry_with_checkpoint --------------------------------------------------


class _QuickSupervisor(StepSupervisor):
    """Runs the thunk inline — retry tests need determinism, not threads."""

    def run(self, fn, *args):
        return fn(*args), 0.0


def test_retry_does_not_launder_programming_bugs():
    restores = []

    def step(state):
        raise RuntimeError("index out of bounds")

    runner = retry_with_checkpoint(step, lambda: restores.append(1) or 0,
                                   supervisor=_QuickSupervisor())
    with pytest.raises(RuntimeError):
        runner(0)
    assert restores == []


def test_retry_environmental_with_capped_backoff():
    sleeps = []
    calls = {"n": 0}

    def step(state):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise HostFailure("preempted")
        return state + 1

    runner = retry_with_checkpoint(
        step, lambda: 10, max_retries=3, supervisor=_QuickSupervisor(),
        backoff_base=1.0, backoff_cap=3.0, sleep=sleeps.append)
    out, _ = runner(10)
    assert out == 11
    assert sleeps == [1.0, 2.0, 3.0]


def test_retry_exhausts_then_raises():
    sleeps = []

    def step(state):
        raise StepTimeout("stuck")

    runner = retry_with_checkpoint(
        step, lambda: 0, max_retries=2, supervisor=_QuickSupervisor(),
        sleep=sleeps.append)
    with pytest.raises(StepTimeout):
        runner(0)
    assert len(sleeps) == 2


def test_retry_opt_in_retryable():
    calls = {"n": 0}

    def step(state):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ConnectionError("transient rpc")
        return state

    runner = retry_with_checkpoint(
        step, lambda: 7, supervisor=_QuickSupervisor(),
        retryable=(ConnectionError,), sleep=lambda s: None)
    out, _ = runner(0)
    assert out == 7


# -- checkpoints ------------------------------------------------------------


def _state():
    params = {"w": torch.arange(12.0).reshape(3, 4),
              "inner": {"b": torch.ones(5).bfloat16()}}
    opt = adamw.init({"w": params["w"], "inner": {"b": torch.ones(5)}})
    return params, opt


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_zeros_like(v) for v in tree))
    return torch.zeros_like(tree)


def test_roundtrip_with_namedtuple(tmp_path):
    params, opt = _state()
    opt = opt._replace(count=torch.tensor(3, dtype=torch.int32))
    ckpt.save(tmp_path, 7, (params, opt))
    like = (_zeros_like(params), _zeros_like(opt))
    p2, o2 = ckpt.restore(tmp_path, 7, like)
    assert p2 is like[0] and isinstance(o2, adamw.OptState)
    assert torch.equal(p2["w"], params["w"])
    assert p2["inner"]["b"].dtype == torch.bfloat16
    assert torch.equal(p2["inner"]["b"], params["inner"]["b"])
    assert int(o2.count) == 3


def test_latest_and_retention(tmp_path):
    params, _ = _state()
    mgr = CheckpointManager(tmp_path, keep=2, save_async=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, params)
    assert ckpt.latest_step(tmp_path) == 4
    kept = sorted(d.name for d in Path(tmp_path).iterdir())
    assert kept == ["step_00000003", "step_00000004"]


def test_restore_or_init(tmp_path):
    params, opt = _state()
    mgr = CheckpointManager(tmp_path, save_async=False)
    state, start = mgr.restore_or_init(lambda: (params, opt))
    assert start == 0
    mgr.save(5, state)
    _, start2 = mgr.restore_or_init(
        lambda: (_zeros_like(params), _zeros_like(opt)))
    assert start2 == 6


def test_corruption_detected(tmp_path):
    params, _ = _state()
    ckpt.save(tmp_path, 1, params)
    d = Path(tmp_path) / "step_00000001"
    shard = next(d.glob("shard_*.npy"))
    np.save(shard, np.load(shard) + 1)
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(tmp_path, 1, _zeros_like(params))


def test_async_save_snapshots_before_an_in_place_update(tmp_path):
    params, opt = _state()
    mgr = CheckpointManager(tmp_path, save_async=True)
    mgr.save(9, (params, opt), extra={"step": 9})
    params["w"].add_(100.0)              # the next step, in place
    mgr.wait()
    assert ckpt.latest_step(tmp_path) == 9
    assert ckpt.manifest_extra(tmp_path, 9) == {"step": 9}
    got = ckpt.restore(tmp_path, 9, (_zeros_like(params),
                                     _zeros_like(opt)))[0]
    assert torch.equal(got["w"], torch.arange(12.0).reshape(3, 4))


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The port restores what the reference saved and the reference
    restores what the port saved: same files, manifest and hashes."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import ckpt as jax_ckpt
    from repro.optim import adamw as jax_adamw
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    jparams = {"w": jnp.asarray(w), "inner": {"b": jnp.asarray(
        b, jnp.bfloat16)}}
    jopt = jax_adamw.init({"w": jnp.asarray(w), "inner": {"b": jnp.asarray(
        b)}})
    jax_ckpt.save(tmp_path / "ref", 2, (jparams, jopt))
    params, opt = _state()
    like = (_zeros_like(params), _zeros_like(opt))
    p2, _ = ckpt.restore(tmp_path / "ref", 2, like)
    np.testing.assert_array_equal(p2["w"].numpy(), w)
    np.testing.assert_array_equal(
        p2["inner"]["b"].float().numpy(),
        np.asarray(jparams["inner"]["b"], np.float32))
    # the port's save, read by the reference
    ckpt.save(tmp_path / "port", 2, (p2, opt))
    jlike = jax.tree.map(jnp.zeros_like, (jparams, jopt))
    jp, jo = jax_ckpt.restore(tmp_path / "port", 2, jlike)
    np.testing.assert_array_equal(np.asarray(jp["w"]), w)
    assert jp["inner"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jp["inner"]["b"], np.float32),
                                  p2["inner"]["b"].float().numpy())
    ref = json.loads((tmp_path / "ref" / "step_00000002" /
                      "manifest.json").read_text())["leaves"]
    port = json.loads((tmp_path / "port" / "step_00000002" /
                       "manifest.json").read_text())["leaves"]
    assert ref == port
