"""Online Maestro engine layer: ``Engine`` (control plane + cost book +
decisions), ``jobs`` (job -> region workflow) and the plain-arm
``ServeEngine`` (continuous batching over the port's batched decode)."""
from repro_torch.engine.engine import Engine
from repro_torch.engine.jobs import Job, TickCandidate
from repro_torch.engine.serve import Request, ServeEngine, SlotPool

__all__ = ["Engine", "Job", "Request", "ServeEngine", "SlotPool",
           "TickCandidate"]
