"""Event categories of the fabric simulator's per-link utilization samples.

The port's copy of the constants ``fabric.sim.simulate(tracer=...)`` emits
under, from the reference's ``repro/obs/timeline.py``; its ``LinkTimeline``
reconstruction comes with the slice that exports traces.
"""

# Event categories shared with fabric.sim's emission.
LINK_CAT = "fabric.link"
LINK_META_CAT = "fabric.link.meta"
