"""Serve-step builder and the batched serving front door.

``BatchedServer.generate`` routes through the engine layer
(:class:`repro_torch.engine.serve.ServeEngine`: continuous batching,
chunked batched prefill, control plane between ticks).  The pre-engine
loop — static batch in lockstep, one decode step per prompt token and per
generated token — survives as ``generate_static``: the baseline and the
output-equivalence oracle of the engine path.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
nothing falls back to the CPU when the card is missing.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.models.params import tree_map


def serving_params(params, device):
    """Weights as the serving path holds them: on ``device``, in bfloat16.
    Every use of a weight in the model casts it to the bf16 activations
    first, so holding them in bf16 is exact and halves the bytes read per
    step."""
    return tree_map(lambda p: p.to(device=device, dtype=torch.bfloat16),
                    params)


def build_serve_step(cfg: ArchConfig):
    nl_moe = lm.n_moe_layers(cfg)

    def serve_step(params, state, token, plan_slots=None, plan_cum=None):
        plan = None
        if nl_moe and plan_slots is not None:
            plan = moe_lib.RoutingPlan(plan_slots, plan_cum)
        return lm.decode_step(params, state, token, cfg, plan=plan)

    return serve_step


def sample(logits, temperature: float = 0.8,
           generator: Optional[torch.Generator] = None):
    """logits [B,V] -> tokens [B] (int64).  Greedy at temperature <= 0
    (ties to the lowest index), categorical otherwise."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


class BatchedServer:
    """Serving front door for examples, tests and the chip smoke run: a thin
    client of the engine layer (one slot pool, the default class)."""

    def __init__(self, cfg: ArchConfig, params, max_len: int = 128,
                 slots: int = 4, prefill_chunk: int = 16,
                 decode_chunk: int = 4, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = serving_params(params, self.device)
        self.max_len = max_len
        self.slots = slots
        self.prefill_chunk = prefill_chunk
        self.decode_chunk = decode_chunk
        self._step = build_serve_step(cfg)
        self._engine = None

    def engine(self, seed: int = 0):
        from repro_torch.engine.serve import ServeEngine
        if self._engine is None:
            self._engine = ServeEngine(
                self.cfg, self.params, max_len=self.max_len,
                slots=self.slots, prefill_chunk=self.prefill_chunk,
                decode_chunk=self.decode_chunk, seed=seed,
                device=self.device)
        return self._engine

    def generate(self, prompts, max_new: int = 16, temperature: float = 0.0,
                 seed: int = 0) -> np.ndarray:
        """Prompts (a ``[B, plen]`` array, or a list of 1-D prompts of mixed
        lengths) -> ``[B, max_new]`` tokens through the serve engine."""
        return self.engine(seed).generate(prompts, max_new, temperature,
                                          seed=seed)

    @torch.no_grad()
    def generate_static(self, prompts: np.ndarray, max_new: int = 16,
                        temperature: float = 0.0, seed: int = 0):
        """The static loop: one decode step per prompt token (prefill) and
        per generated token, the whole batch in lockstep and routed as one
        MoE group."""
        b, plen = prompts.shape
        state = lm.init_cache(self.cfg, b, self.max_len, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=self.device)
        logits = None
        for i in range(plen):
            logits, state = self._step(self.params, state, toks[:, i:i + 1])
        out = []
        tok = sample(logits, temperature, gen)[:, None]
        for _ in range(max_new):
            out.append(tok)
            logits, state = self._step(self.params, state, tok)
            tok = sample(logits, temperature, gen)[:, None]
        return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
