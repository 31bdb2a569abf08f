"""Roofline analysis from the dry-run's walk.

The port of the reference's ``repro/roofline/analysis.py``. Three terms
per (arch x shape x mesh), all in seconds per step:

    compute    = walker FLOPs       / peak FLOP/s        (per chip)
    memory     = walker bytes       / HBM bandwidth      (per chip)
    collective = collective bytes   / link bandwidth     (per chip)

The walker (``roofline/hlo_walk.py``) counts one rank's ops, so no further
division by chip count. ``collective_stats`` reads the walker's op record
where the reference parses HLO text: the result bytes of every all-gather,
all-reduce, reduce-scatter, all-to-all and collective-permute (a lower
bound on the bytes a ring moves). ``chip`` defaults to the reference's TPU
v5e (``hw.V5E``); a caller that wants a card's roofline builds a
``ChipSpec`` from that card's measured rates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.roofline import hw

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_stats(op_record: list) -> dict:
    """Sum the result bytes of the collectives in a walker op record
    (``analyze(..., record=True)["op_record"]``), by kind."""
    by_kind: dict[str, int] = {k: 0 for k in _COLL_KINDS}
    counts: dict[str, int] = {k: 0 for k in _COLL_KINDS}
    for _, kind, nbytes in op_record:
        if kind in by_kind:
            by_kind[kind] += int(nbytes)
            counts[kind] += 1
    return {"total_bytes": sum(by_kind.values()), "bytes_by_kind": by_kind,
            "counts": counts}


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops: float                # per-chip walker flops
    hbm_bytes: float            # per-chip bytes accessed
    collective_bytes: float     # per-chip collective result bytes
    model_flops: float          # 6*N*D analytic (per chip)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    flops_ratio: float          # model_flops / walker flops
    peak_memory_bytes: Optional[int] = None
    collective_detail: Optional[dict] = None
    note: str = ""

    @classmethod
    def build(cls, *, arch, shape, mesh, flops, hbm_bytes, collective_bytes,
              model_flops, chip: hw.ChipSpec = hw.V5E, peak_memory=None,
              collective_detail=None, note="") -> "Roofline":
        t_c = flops / chip.peak_flops
        t_m = hbm_bytes / chip.hbm_bandwidth
        t_x = collective_bytes / chip.ici_bandwidth
        terms = {"compute": t_c, "memory": t_m, "collective": t_x}
        bottleneck = max(terms, key=terms.get)
        return cls(arch=arch, shape=shape, mesh=mesh, flops=flops,
                   hbm_bytes=hbm_bytes, collective_bytes=collective_bytes,
                   model_flops=model_flops, t_compute=t_c, t_memory=t_m,
                   t_collective=t_x, bottleneck=bottleneck,
                   flops_ratio=(model_flops / flops) if flops else 0.0,
                   peak_memory_bytes=peak_memory,
                   collective_detail=collective_detail, note=note)

    @property
    def step_time(self) -> float:
        """Roofline step time (terms overlap perfectly -> max)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """How close the dominant term pins the hardware: useful-compute
        time / roofline step time (useful compute at the reference's v5e
        peak, as the reference computes it)."""
        t_useful = self.model_flops / hw.V5E.peak_flops
        return t_useful / self.step_time if self.step_time else 0.0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["step_time"] = self.step_time
        d["roofline_fraction"] = self.roofline_fraction
        return d


def model_flops_per_step(cfg, shape, n_chips: int, backward: bool) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N = active params.

    Per-chip: divided by chip count. D = tokens processed this step.
    """
    n = cfg.active_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:
        tokens = shape.global_batch          # one token per sequence
        mult = 2.0
    return mult * n * tokens / n_chips


def summarize(results: list[Roofline]) -> str:
    """Markdown table of roofline rows."""
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "bottleneck | MODEL/HLO flops | roofline frac | note |")
    sep = "|" + "---|" * 10
    rows = [hdr, sep]
    for r in results:
        rows.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.t_compute:.3e} | "
            f"{r.t_memory:.3e} | {r.t_collective:.3e} | {r.bottleneck} | "
            f"{r.flops_ratio:.2f} | {r.roofline_fraction:.2f} | {r.note} |")
    return "\n".join(rows)
