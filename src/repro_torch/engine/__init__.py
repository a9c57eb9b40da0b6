"""Online Maestro engine layer: ``Engine`` (control plane + cost book +
decisions), ``jobs`` (job -> region workflow), ``ServeEngine`` (continuous
batching over the port's batched decode, on one or several slot pools with
priority classes and compact decode, with the speculative arms and their
``PROPOSERS``), ``prefix_cache`` (the radix tree of slot-row snapshots and
the exact-hit result cache), ``draft`` (draft models for the draft arm),
``autotune`` (the knob autotuner) and ``loadgen`` (seeded scenarios and the
virtual-time drive harness)."""
from repro_torch.engine.autotune import AutoTuner, Knob
from repro_torch.engine.draft import (distill_draft, greedy_streams,
                                      slice_draft_params, small_draft_cfg,
                                      truncated_draft_cfg)
from repro_torch.engine.engine import Engine
from repro_torch.engine.jobs import Job, TickCandidate
from repro_torch.engine.prefix_cache import (PrefixAnalyzer, PrefixCache,
                                             request_fingerprint)
from repro_torch.engine.serve import (PROPOSERS, DraftProposer, NgramProposer,
                                      Proposer, Request, ServeEngine,
                                      SlotPool)

__all__ = ["AutoTuner", "DraftProposer", "Engine", "Job", "Knob", "NgramProposer", "PROPOSERS",
           "PrefixAnalyzer", "PrefixCache", "Proposer", "Request",
           "ServeEngine", "SlotPool", "TickCandidate", "distill_draft",
           "greedy_streams", "request_fingerprint", "slice_draft_params",
           "small_draft_cfg", "truncated_draft_cfg"]
