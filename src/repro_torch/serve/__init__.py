"""repro_torch.serve — anytime online allocation serving (port of
``repro.serve``).

The event-driven counterpart of ``repro_torch.fleet.replay``: asynchronous
demand arrival, tenants registering and departing over a fixed bank of
batch lanes (the solve's shapes never change while the service is live),
and an enforced per-tick wall-clock budget through
``core.pgd.AnytimeConfig`` — each tick deploys the chunked solve's
best-so-far feasible iterate when the budget expires.
``python -m repro_torch.serve`` runs the flash-crowd demo on the card
(``--device cpu`` on the CPU)."""
from .engine import DecisionRecord, ServeEngine, ServeSummary

__all__ = ["DecisionRecord", "ServeEngine", "ServeSummary"]
