"""HEIMDALL harness: low-noise timing, tier placement and CSV rows.

The port of the reference's ``repro/heimdall/harness.py``: the same
repetitions, warm-up and median-of-runs reporting, with a CUDA device
synchronise where the reference blocks on JAX's dispatch
(``jax.block_until_ready``), and tiers placed with PyTorch (``place``).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class Row:
    name: str
    us_per_call: float
    derived: str                 # free-form derived metric, e.g. "GiB/s=12.3"
    n_reruns: int = 0            # noise-guard reruns behind this number

    def csv(self) -> str:
        # reruns ride inside the derived field: the CSV stays 3 columns,
        # so every existing consumer's name,us,derived split keeps working
        derived = self.derived if not self.n_reruns \
            else f"{self.derived};n_reruns={self.n_reruns}"
        return f"{self.name},{self.us_per_call:.3f},{derived}"


@dataclasses.dataclass(frozen=True)
class Timing:
    """One timed measurement with its noise signature.

    ``dispersion`` (IQR/median) is the noise guard: a measurement whose
    repetitions scatter widely carries little information and gets rerun
    instead of silently reported.
    """
    median: float                # seconds per call
    iqr: float                   # interquartile range of the repetitions
    times: tuple                 # raw per-iteration seconds
    n_reruns: int = 0            # noise-guard retries taken (0 = first try)

    @property
    def dispersion(self) -> float:
        """IQR/median — scale-free instability measure (0 = perfectly
        repeatable; >~0.1 means the median is dominated by scheduler or
        allocator noise)."""
        return self.iqr / self.median if self.median > 0 else float("inf")


def _block_until_ready(out) -> None:
    """Wait for the device work behind ``out`` (a tensor or a tuple/list
    of them): a CUDA synchronise for each CUDA device it lies on."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for dev in {t.device for t in outs if isinstance(t, torch.Tensor)
                and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_fn_stats(fn: Callable, *args, warmup: int = 3, iters: int = 10,
                  inner: int = 1,
                  max_dispersion: Optional[float] = None,
                  max_reruns: int = 2) -> Timing:
    """Like ``time_fn`` but returns the full ``Timing`` (median + IQR
    dispersion) so callers can judge measurement stability.

    With ``max_dispersion`` set, a measurement whose dispersion exceeds it
    is remeasured (up to ``max_reruns`` times) and the *stablest* run wins;
    ``Timing.n_reruns`` records how many retries stand behind the number
    (0 = clean first measurement), and ``Row`` surfaces it in the CSV.
    """
    def _measure() -> Timing:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            for _ in range(inner):
                out = fn(*args)
            _block_until_ready(out)
            times.append((time.perf_counter() - t0) / inner)
        med = statistics.median(times)
        if len(times) >= 2:
            q = statistics.quantiles(times, n=4, method="inclusive")
            iqr = q[2] - q[0]
        else:
            iqr = 0.0
        return Timing(med, iqr, tuple(times))

    for _ in range(warmup):
        out = fn(*args)
        _block_until_ready(out)
    best = _measure()
    if max_dispersion is None:
        return best
    reruns = 0
    while best.dispersion > max_dispersion and reruns < max_reruns:
        reruns += 1
        t = _measure()
        if t.dispersion < best.dispersion:
            best = t
    return dataclasses.replace(best, n_reruns=reruns)


def time_fn(fn: Callable, *args, warmup: int = 3, iters: int = 10,
            inner: int = 1) -> float:
    """Median wall-time per call in seconds."""
    return time_fn_stats(fn, *args, warmup=warmup, iters=iters,
                         inner=inner).median


_TIERS = ("hbm", "device", "host", "pinned_host")


def host_empty(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """An uninitialised tensor in host-tier memory for a pool that lives on
    ``device``: CPU memory, pinned when ``device`` is a CUDA device
    (pinning needs a CUDA build and card)."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def place(x: torch.Tensor, tier: str, device) -> torch.Tensor:
    """``x`` in ``tier``'s memory for a pool that lives on ``device``:
    'hbm' -> on ``device``; 'host' -> ``host_empty``'s memory."""
    if tier not in _TIERS:
        raise ValueError(
            f"unknown tier {tier!r}: PyTorch can only place tensors in "
            f"{sorted(_TIERS)}; simulated-only tiers (e.g. 'pool') live in "
            f"repro_torch.fabric system presets, not here")
    if tier in ("hbm", "device"):
        return x.to(device)
    return host_empty(x.shape, x.dtype, device).copy_(x)


TIERS = ("hbm", "host")
