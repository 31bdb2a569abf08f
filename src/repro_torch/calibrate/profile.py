"""Versioned calibration artifacts: samples, link estimates, profiles.

The port's copy of the reference's ``repro/calibrate/profile.py``: the same
records and JSON schema (a profile written by either package loads in the
other), with ``machine_metadata`` recording PyTorch, CUDA and the card.

A ``CalibrationProfile`` is the serialized output of the measure->fit loop:
per-route ``LinkEstimate``s (fitted bandwidth/latency plus the efficiency
factor vs. the nominal preset), the raw ``LinkSample`` provenance they were
fitted from, and machine metadata — the artifact ``fabric.systems.
from_profile`` turns back into a calibrated ``System`` and ``validate``
holds the simulator accountable to.

The JSON schema is versioned (``PROFILE_VERSION``). Loading tolerates
unknown fields (forward compatibility: a newer writer may add keys) but
rejects missing/mistyped known fields with a ``ProfileError`` naming the
offending field — a malformed artifact must fail loudly at load time, not
as a nonsense simulation three layers up.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
from typing import Optional

PROFILE_VERSION = 1


class ProfileError(ValueError):
    """A calibration artifact failed validation; the message names the
    offending field (e.g. ``links[2].bandwidth``)."""


@dataclasses.dataclass(frozen=True)
class LinkSample:
    """One measured transfer: ``nbytes`` moved src->dst in ``seconds``.

    ``src``/``dst`` are fabric node names of the measured route's endpoints
    (memory node -> reference compute, the read direction HEIMDALL probes).
    ``dispersion`` is the timing's IQR/median (``harness.Timing``): the
    fitter down-weights unstable samples instead of fitting noise.
    ``source`` records provenance: ``"torch"`` (CUDA-event times of copies
    on the card; the reference writes ``"jax"`` for its wall-clock probe)
    or ``"emulated"`` (the deterministic ground-truth machine used when the
    hardware tier is not addressable from this container).
    """
    system: str
    src: str
    dst: str
    link_type: str               # bottleneck link type on the nominal route
    nbytes: int
    seconds: float
    dispersion: float
    source: str = "emulated"
    reruns: int = 0              # times the noise guard re-measured this


@dataclasses.dataclass(frozen=True)
class LinkEstimate:
    """Fitted constants of one measured route (memory node -> compute).

    ``bandwidth``/``latency`` are the robust fit of ``seconds ~= nbytes/bw
    + lat`` over that route's samples; ``efficiency`` and ``latency_ratio``
    are the fit relative to the nominal preset route (the numbers
    ``from_profile`` rescales preset links by). ``rel_residual`` is the
    weighted relative RMS residual of the fit — the fit-quality number the
    calibration benchmark family thresholds.
    """
    src: str
    dst: str
    link_type: str
    bandwidth: float             # bytes/s, fitted
    latency: float               # seconds, fitted
    efficiency: float            # fitted bw / nominal route bw
    latency_ratio: float         # fitted lat / nominal route lat
    n_samples: int
    n_downweighted: int          # unstable or outlier samples de-emphasized
    rel_residual: float


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """The measure->fit artifact one ``CalibrationRunner`` pass produces."""
    system: str                  # preset the measurements were taken against
    links: tuple                 # tuple[LinkEstimate]
    samples: tuple = ()          # tuple[LinkSample] provenance
    source: str = "emulated"     # "torch" | "emulated" | "mixed"
    machine: dict = dataclasses.field(default_factory=dict)
    version: int = PROFILE_VERSION

    def estimate(self, src: str, dst: str) -> LinkEstimate:
        for est in self.links:
            if est.src == src and est.dst == dst:
                return est
        raise KeyError(f"no estimate for route {src}->{dst} in profile "
                       f"({self.system}); have "
                       f"{[(e.src, e.dst) for e in self.links]}")

    def predicted_time(self, src: str, dst: str, nbytes: float) -> float:
        """Fitted-constant transfer time for ``nbytes`` on the measured
        ``src -> dst`` route: ``nbytes / bandwidth + latency``.

        This is the profile's own closed-form prediction — what the drift
        sentinel (``repro_torch.obs.drift``) replays observed timings against
        without rebuilding a full calibrated ``System``. Raises ``KeyError``
        for a route the profile never measured.
        """
        est = self.estimate(src, dst)
        return nbytes / est.bandwidth + est.latency

    def tier_measurements(self, system=None) -> dict:
        """Per-tier measurement dict for ``TierTopology.from_calibration``
        — the round-trip bridge: the same fitted route constants expressed
        in tier vocabulary (read/write bw = fitted route bandwidth, latency
        = fitted route latency, capacity/kind from the fabric node)."""
        from repro_torch.fabric.systems import get_system
        system = system or get_system(self.system)
        out = {}
        for tier, node in system.tier_map.items():
            if node == system.compute:
                continue
            try:
                est = self.estimate(node, system.compute)
            except KeyError:
                continue
            n = system.fabric.node(node)
            out[tier] = dict(capacity=n.capacity, read_bw=est.bandwidth,
                             write_bw=est.bandwidth, latency=est.latency,
                             memory_kind=n.memory_kind)
        return out

    # -- serialization -------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "version": self.version,
            "system": self.system,
            "source": self.source,
            "machine": dict(self.machine),
            "links": [dataclasses.asdict(e) for e in self.links],
            "samples": [dataclasses.asdict(s) for s in self.samples],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def from_json(cls, data: dict) -> "CalibrationProfile":
        if not isinstance(data, dict):
            raise ProfileError(f"profile: expected object, got "
                               f"{type(data).__name__}")
        version = _field(data, "version", int, "")
        if version > PROFILE_VERSION:
            raise ProfileError(
                f"version: profile version {version} is newer than this "
                f"reader ({PROFILE_VERSION}); refusing to misread it")
        links = _field(data, "links", list, "")
        samples = data.get("samples", [])
        if not isinstance(samples, list):
            raise ProfileError("samples: expected array, got "
                               f"{type(samples).__name__}")
        return cls(
            system=_field(data, "system", str, ""),
            source=str(data.get("source", "emulated")),
            machine=dict(data.get("machine") or {}),
            links=tuple(_load_record(LinkEstimate, e, f"links[{i}]")
                        for i, e in enumerate(links)),
            samples=tuple(_load_record(LinkSample, s, f"samples[{i}]")
                          for i, s in enumerate(samples)),
            version=version,
        )

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        with open(path) as f:
            try:
                data = json.load(f)
            except json.JSONDecodeError as e:
                raise ProfileError(f"{path}: not valid JSON ({e})") from None
        return cls.from_json(data)


def load_profile(profile) -> CalibrationProfile:
    """``profile`` itself, or the profile loaded from it where it is a path
    to a JSON artifact (how every consumer's ``calibration_profile=``
    takes either)."""
    if isinstance(profile, (str, os.PathLike)):
        return CalibrationProfile.load(profile)
    return profile


def _field(data: dict, key: str, typ, ctx: str):
    """Required typed field; ProfileError names ``ctx.key`` on failure."""
    name = f"{ctx}.{key}" if ctx else key
    if key not in data:
        raise ProfileError(f"{name}: missing required field")
    val = data[key]
    if typ is float and isinstance(val, int) and not isinstance(val, bool):
        val = float(val)
    if not isinstance(val, typ) or isinstance(val, bool) and typ is not bool:
        raise ProfileError(f"{name}: expected {typ.__name__}, got "
                           f"{type(val).__name__} ({val!r})")
    return val


def _load_record(cls, data: dict, ctx: str):
    """Build a frozen record from JSON: required fields checked and typed,
    optional fields defaulted, unknown fields tolerated (and dropped)."""
    if not isinstance(data, dict):
        raise ProfileError(f"{ctx}: expected object, got "
                           f"{type(data).__name__}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        typ = {"str": str, "int": int, "float": float}.get(f.type, object)
        has_default = (f.default is not dataclasses.MISSING
                       or f.default_factory is not dataclasses.MISSING)
        if f.name not in data:
            if has_default:
                continue
            raise ProfileError(f"{ctx}.{f.name}: missing required field")
        kwargs[f.name] = (_field(data, f.name, typ, ctx)
                          if typ is not object else data[f.name])
    return cls(**kwargs)


def machine_metadata() -> dict:
    """Provenance metadata stamped into profiles: the platform, PyTorch and
    its CUDA, and where a card is present its name and the power limit
    ``nvidia-smi`` reports (a card below its full limit runs slower)."""
    meta = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "machine": platform.machine(),
    }
    import torch
    meta["torch"] = torch.__version__
    meta["cuda"] = torch.version.cuda
    if torch.cuda.is_available():
        meta["device"] = torch.cuda.get_device_name(0)
        limit = _power_limit()
        if limit is not None:
            meta["power_limit"] = limit
    return meta


def _power_limit() -> Optional[str]:
    """The first card's power limit as ``nvidia-smi`` prints it, or None
    where the tool is missing or fails (metadata is best-effort)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None
