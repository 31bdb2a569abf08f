"""Fault tolerance: step supervision, retry, straggler mitigation.

The port's copy of the reference's ``repro/runtime/fault.py`` (pure Python):

  * ``StepSupervisor`` — watchdog: a step exceeding ``timeout_factor`` x the
    trailing median step time is declared hung and raises ``StepTimeout``;
    the training loop restarts from the last checkpoint. A thunk that takes a
    ``cancel=`` keyword receives an event set when the watchdog fires. The
    step runs in a thread that shares the default CUDA stream, so a thunk
    that drives the card ends in a device synchronise (``launch/train.py``
    does) and ``dt`` then covers the device work.
  * ``retry_with_checkpoint`` — bounded retry with checkpoint restore and
    capped exponential backoff, for *environmental* failures only
    (``StepTimeout``, ``HostFailure`` and an opt-in ``retryable`` tuple).
  * ``StragglerStats`` — per-step timing histogram; sustained tail
    inflation flags a straggler.
"""

from __future__ import annotations

import inspect
import statistics
import threading
import time
from typing import Callable, Optional


class StepTimeout(RuntimeError):
    pass


class HostFailure(RuntimeError):
    pass


def _accepts_cancel(fn: Callable) -> bool:
    """Does ``fn`` take a ``cancel=`` keyword (directly or via **kwargs)?"""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):      # builtins / C callables
        return False
    for p in params:
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            return True
        if p.name == "cancel" and p.kind in (
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.KEYWORD_ONLY):
            return True
    return False


class StepSupervisor:
    """Watchdog around blocking step calls.

    ``clock`` is injectable so step durations are testable without real
    sleeps; the timeout wait itself is wall-clock (``Thread.join``). A
    thunk that accepts a ``cancel=`` keyword receives a
    ``threading.Event`` that is set when the watchdog fires, so it can
    stop cooperatively; ``cancel_grace`` bounds how long the supervisor
    waits for that exit before abandoning the (daemon) thread, and ``None``
    waits until the thunk returns (for a step that updates its state in
    place, which must not be restored while the step still writes it).
    """

    def __init__(self, timeout_factor: float = 5.0,
                 min_timeout: float = 60.0, history: int = 20,
                 clock: Callable[[], float] = time.perf_counter,
                 cancel_grace: Optional[float] = 0.5):
        self.timeout_factor = timeout_factor
        self.min_timeout = min_timeout
        self.times: list[float] = []
        self.history = history
        self.clock = clock
        self.cancel_grace = cancel_grace

    @property
    def timeout(self) -> float:
        if not self.times:
            return self.min_timeout
        med = statistics.median(self.times)
        return max(self.min_timeout, self.timeout_factor * med)

    def run(self, fn: Callable, *args):
        cancel = threading.Event()
        kwargs = {"cancel": cancel} if _accepts_cancel(fn) else {}
        result = {}
        err = {}

        def target():
            try:
                t0 = self.clock()
                result["out"] = fn(*args, **kwargs)
                result["dt"] = self.clock() - t0
            except Exception as e:       # noqa: BLE001
                err["e"] = e

        th = threading.Thread(target=target, daemon=True,
                              name="step-supervisor")
        th.start()
        th.join(self.timeout)
        if th.is_alive():
            # Signal the thunk and give it a bounded window to exit; a
            # non-cooperative thunk is abandoned (daemon) but a cancel-aware
            # one unwinds cleanly instead of leaking a zombie thread.
            cancel.set()
            th.join(self.cancel_grace)
            hist = (f"trailing median "
                    f"{statistics.median(self.times):.1f}s over "
                    f"{len(self.times)} steps" if self.times
                    else "no step history yet")
            raise StepTimeout(f"step exceeded {self.timeout:.0f}s ({hist})")
        if "e" in err:
            raise err["e"]
        self.times.append(result["dt"])
        self.times = self.times[-self.history:]
        return result["out"], result["dt"]


class StragglerStats:
    """Flags sustained step-time inflation (p95/median ratio).

    The detection signal of both the training fault loop and the serving
    degradation loop: a healthy window has p95 close to its median; a
    degraded link or sick host stretches the tail first. ``min_samples``
    guards against firing on a near-empty window.
    """

    def __init__(self, window: int = 50, ratio: float = 1.5,
                 min_samples: int = 10):
        self.window = window
        self.ratio = ratio
        self.min_samples = max(2, min_samples)
        self.times: list[float] = []

    def record(self, dt: float):
        self.times.append(dt)
        self.times = self.times[-self.window:]

    def _stats(self) -> tuple:
        s = sorted(self.times)
        # statistics.median averages the middle pair on even-length
        # windows; s[len//2] would pick the upper element, which on a
        # bimodal window inflates the denominator and masks real tails
        return (statistics.median(s), s[min(len(s) - 1,
                                            int(len(s) * 0.95))])

    @property
    def inflated(self) -> bool:
        if len(self.times) < self.min_samples:
            return False
        med, p95 = self._stats()
        return p95 > self.ratio * med

    def summary(self) -> dict:
        if not self.times:
            return {}
        med, p95 = self._stats()
        return {"median_s": med, "p95_s": p95, "n": len(self.times),
                "inflated": self.inflated}


def retry_with_checkpoint(step_fn: Callable, restore_fn: Callable,
                          max_retries: int = 3,
                          supervisor: Optional[StepSupervisor] = None,
                          retryable: tuple = (),
                          backoff_base: float = 1.0,
                          backoff_cap: float = 30.0,
                          sleep: Callable[[float], None] = time.sleep):
    """Run ``step_fn(state) -> state`` once, retrying through
    ``restore_fn() -> state`` on *environmental* failure.

    Retried: ``StepTimeout``, ``HostFailure``, and anything in
    ``retryable`` (opt-in, e.g. a deployment's transient RPC error). A
    bare ``RuntimeError`` — or any other exception — is a programming bug
    and propagates immediately; retrying it through checkpoint restore
    would silently re-execute the same broken step forever.

    Between attempts the runner sleeps ``min(backoff_cap,
    backoff_base * 2**(attempt-1))`` seconds; ``sleep`` is injectable so
    tests assert the backoff sequence without real waiting.
    """
    sup = supervisor or StepSupervisor()
    catch = (StepTimeout, HostFailure, *tuple(retryable))

    def run(state):
        attempts = 0
        while True:
            try:
                return sup.run(step_fn, state)
            except catch:
                attempts += 1
                if attempts > max_retries:
                    raise
                sleep(min(backoff_cap, backoff_base * 2 ** (attempts - 1)))
                state = restore_fn()
    return run
