"""Request front door: the SLO classes and the pure admission/shedding
math (``slo``), which the signal plane reads. The router, the load
generator and token streaming are ROADMAP A6(d)."""

from .slo import DEFAULT_CLASSES, SLOClass, resolve_class, shed_reason  # noqa: F401
