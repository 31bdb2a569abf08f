"""HEIMDALL harness: low-noise timing, tier placement and CSV rows.

The port of the reference's ``repro/heimdall/harness.py``: the same
repetitions, warm-up and median-of-runs reporting, with a CUDA device
synchronise where the reference blocks on JAX's dispatch
(``jax.block_until_ready``), and tiers placed with PyTorch (``place``).

What the port's probes add: ``copy_time_stats`` times a read-direction
bulk copy with CUDA events around the copy alone (the calibration probe),
and ``on_streams`` runs probes side by side on their own CUDA streams
(``side_streams``; a chase under a concurrent bandwidth load). A kernel
reads a host-tier buffer, pinned memory, through its mapped device
pointer, which the probe kernels' C entry points ask the runtime for
(``repro_torch.kernels.probes``).
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


def _stats(times: list) -> Timing:
    """Median and IQR of per-repetition ``times`` (seconds)."""
    med = statistics.median(times)
    if len(times) >= 2:
        q = statistics.quantiles(times, n=4, method="inclusive")
        iqr = q[2] - q[0]
    else:
        iqr = 0.0
    return Timing(med, iqr, tuple(times))


def block_until_ready(out) -> None:
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
            block_until_ready(out)
            times.append((time.perf_counter() - t0) / inner)
        return _stats(times)

    for _ in range(warmup):
        out = fn(*args)
        block_until_ready(out)
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


# clock cycles a spin kernel holds the stream while the host enqueues a
# probe's copies: about 2 ms at the H100's 1.98 GHz boost clock, many times
# the host's time to enqueue one probe's nine copies
HOLD_CYCLES = 4_000_000


def copy_time_stats(x: torch.Tensor, device, *, warmup: int = 2,
                    iters: int = 7) -> Timing:
    """Per-copy time of reading ``x`` (on any tier) into a fresh buffer on
    ``device``. On a CUDA device each copy sits between two CUDA events,
    and its time is the copy's own, its latency included: the stream is
    first held by a spin kernel while the host enqueues every copy, so no
    event waits on Python's dispatch, and the L2 is overwritten (twice its
    size) before each copy, so an HBM source is read from HBM. On the CPU,
    the host clock around a copy between host buffers."""
    device = torch.device(device)
    n = warmup + iters
    dsts = [torch.empty_like(x, device=device) for _ in range(n)]
    if device.type != "cuda":
        times = []
        for dst in dsts:
            t0 = time.perf_counter()
            dst.copy_(x)
            times.append(time.perf_counter() - t0)
        return _stats(times[warmup:])
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    flush = torch.empty(2 * l2 // 4, dtype=torch.float32, device=device)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda.synchronize(device)
    torch.cuda._sleep(HOLD_CYCLES)
    for dst, (start, end) in zip(dsts, events):
        flush.zero_()
        start.record()
        dst.copy_(x, non_blocking=True)
        end.record()
    torch.cuda.synchronize(device)
    return _stats([s.elapsed_time(e) / 1e3 for s, e in events[warmup:]])


def side_streams(n: int, device) -> list:
    """``n`` CUDA streams of ``device`` for ``on_streams`` (``None`` each on
    the CPU). Make them once per benchmark, outside its timed calls: the
    caching allocator keeps a pool per stream, so a fresh stream per call
    would allocate device memory anew inside the timing."""
    device = torch.device(device)
    if device.type != "cuda":
        return [None] * n
    return [torch.cuda.Stream(device) for _ in range(n)]


def on_streams(calls: list, streams: list) -> list:
    """``[call() for call in calls]``, each on its own stream of
    ``streams`` (``side_streams``), started together after the current
    stream's work and joined back into it (the current stream waits for
    every one); on the CPU (streams of ``None``), in order. Returns their
    results."""
    if streams[0] is None:
        return [call() for call in calls]
    main = torch.cuda.current_stream(streams[0].device)
    out = []
    for stream, call in zip(streams, calls):
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out.append(call())
    for stream, res in zip(streams, out):
        main.wait_stream(stream)
        for t in res if isinstance(res, (tuple, list)) else (res,):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                t.record_stream(main)
    return out


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
