"""Per-link utilization timelines reconstructed from trace events.

The port's copy of the reference's ``repro/obs/timeline.py``.

``fabric.sim.simulate(tracer=...)`` emits one counter sample per physical
link at every arbitration event (fraction-of-capacity per QoS class, a
piecewise-constant function of time) plus one metadata instant carrying the
link's capacity. ``link_timelines`` parses those events back into
``LinkTimeline`` objects, so consumers can integrate bandwidth over time —
the byte-conservation check in ``heimdall.obs`` asserts that the integral
of every link's utilization timeline equals the bytes the ``FlowResult``s
say crossed it (the timeline and the results must be two views of one
simulation, not two simulations).

Reconstructing from the *emitted events* rather than from simulator
internals is deliberate: it validates the exported trace, not a private
side channel.
"""

from __future__ import annotations

import dataclasses

# Event categories shared with fabric.sim's emission.
LINK_CAT = "fabric.link"
LINK_META_CAT = "fabric.link.meta"


@dataclasses.dataclass(frozen=True)
class LinkTimeline:
    """Piecewise-constant utilization of one physical link.

    ``samples`` holds ``(ts, {class_label: fraction})`` in time order; each
    sample's fractions hold until the next sample's timestamp. The last
    sample is the all-idle one the simulator emits when it drains, so the
    timeline is fully bounded.
    """
    link: str                    # e.g. "host_dram->chip0:pcie"
    capacity: float              # bytes/s
    samples: tuple               # ((ts, {label: fraction}), ...)

    @property
    def end_ts(self) -> float:
        return self.samples[-1][0] if self.samples else 0.0

    def max_utilization(self) -> float:
        """Peak total (all QoS classes) fraction-of-capacity."""
        return max((sum(fr.values()) for _, fr in self.samples),
                   default=0.0)

    def bytes_moved(self) -> float:
        """Integral of utilization x capacity over the timeline."""
        total = 0.0
        for (t0, fr), (t1, _) in zip(self.samples, self.samples[1:]):
            total += sum(fr.values()) * self.capacity * (t1 - t0)
        return total

    def bytes_by_class(self) -> dict:
        """Per-QoS-class integral (bytes moved in each class)."""
        out: dict[str, float] = {}
        for (t0, fr), (t1, _) in zip(self.samples, self.samples[1:]):
            for label, f in fr.items():
                out[label] = out.get(label, 0.0) + f * self.capacity \
                    * (t1 - t0)
        return out


def link_timelines(tracer, process: str = "fabric") -> dict:
    """Rebuild ``{link label: LinkTimeline}`` from a tracer's events.

    ``process`` selects which track process to read (a scoped simulate run
    emits under ``"<prefix>/fabric"``)."""
    caps: dict[str, float] = {}
    samples: dict[str, list] = {}
    for ev in tracer.events:
        if ev.track[0] != process:
            continue
        if ev.cat == LINK_META_CAT:
            caps[ev.args["link"]] = ev.args["capacity"]
        elif ev.cat == LINK_CAT and ev.kind == "C":
            samples.setdefault(ev.name, []).append(
                (ev.ts, dict(ev.args or {})))
    out = {}
    for link, s in samples.items():
        if link not in caps:
            raise ValueError(f"utilization samples for {link!r} without a "
                             f"capacity metadata event")
        s.sort(key=lambda x: x[0])
        out[link] = LinkTimeline(link, caps[link], tuple(s))
    return out
