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

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.models.blocks import BLOCKS


def serving_params(params, device):
    """Weights as the serving path holds them: on ``device``, in bfloat16,
    except the leaves a block reads in f32 (``BLOCKS[t]["f32"]``), which
    keep their dtype.  Every other use of a weight casts it to the bf16
    activations first, so this is exact and halves the bytes read per
    step.  Leaves may be tensors or numpy arrays (a published host tree);
    a tensor already on ``device`` in its serving dtype is kept as is."""
    def leaf(p, keep_dtype):
        p = torch.as_tensor(p)
        return p.to(device=device,
                    dtype=p.dtype if keep_dtype else torch.bfloat16)

    return {k: {n: leaf(p, n in BLOCKS[k]["f32"]) for n, p in v.items()}
            if k in BLOCKS else leaf(v, False) for k, v in params.items()}


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
    client of the engine layer.

    ``pools`` > 1 spreads requests over several slot pools arbitrated by
    the engine's weighted-FRT objective, and ``class_pools`` (class name ->
    tuple of admissible pool ids) pins traffic classes to pools — e.g. pool
    0 for the interactive class while batch traffic shares the rest.
    ``generate`` takes an optional per-prompt ``priorities`` list naming
    ``cfg.serve.classes`` entries; ``submit`` is the streaming entry point
    with the same knobs.  ``compact_decode`` pins (True/False) or leaves to
    the engine (None) the compact layout of sparse decode ticks;
    ``autotune`` turns on the knob autotuner.
    ``spec_decode`` offers the engine the speculative decode arms;
    ``draft="self"`` slices a truncated self-draft from the params, or an
    independent ``draft_cfg`` + ``draft_params`` (e.g. from
    ``engine.draft.distill_draft``) gives the draft arm its model;
    ``prefix_cache`` turns on the cross-request prefix and result cache.
    ``placements`` (pool id -> a device, its name, a sequence of them or
    a pool mesh) places pools on device groups (``ServeEngine``).
    Greedy outputs are the same with any of them."""

    def __init__(self, cfg: ArchConfig, params, max_len: int = 128,
                 slots: int = 4, prefill_chunk: int = 16,
                 decode_chunk: int = 4, spec_decode: bool = False,
                 prefix_cache: bool = False, draft: Optional[str] = None,
                 draft_cfg: Optional[ArchConfig] = None, draft_params=None,
                 pools: int = 1, class_pools: Optional[Dict] = None,
                 compact_decode: Optional[bool] = None, autotune=False,
                 placements: Optional[Dict] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = serving_params(params, self.device)
        self.max_len = max_len
        self.slots = slots
        self.prefill_chunk = prefill_chunk
        self.decode_chunk = decode_chunk
        self.spec_decode = spec_decode
        self.prefix_cache = prefix_cache
        self.draft = draft
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.pools = pools
        self.class_pools = class_pools
        self.compact_decode = compact_decode
        self.autotune = autotune
        self.placements = placements
        self._step = build_serve_step(cfg)
        self._engine = None

    def engine(self, seed: int = 0):
        from repro_torch.engine.serve import ServeEngine
        if self._engine is None:
            self._engine = ServeEngine(
                self.cfg, self.params, max_len=self.max_len,
                slots=self.slots, prefill_chunk=self.prefill_chunk,
                decode_chunk=self.decode_chunk, seed=seed,
                compact_decode=self.compact_decode,
                spec_decode=self.spec_decode, pools=self.pools,
                class_pools=self.class_pools,
                prefix_cache=self.prefix_cache, draft=self.draft,
                draft_cfg=self.draft_cfg, draft_params=self.draft_params,
                placements=self.placements, autotune=self.autotune,
                device=self.device)
        return self._engine

    def submit(self, prompt, max_new: int = 16, temperature: float = 0.0,
               priority: Optional[str] = None, pool: Optional[int] = None):
        """Streaming entry point: queue one request on the engine and return
        the live :class:`repro_torch.engine.Request` (drive it with
        ``engine().tick()`` or ``engine().run_until_done()``)."""
        return self.engine().submit(prompt, max_new, temperature,
                                    priority=priority, pool=pool)

    def generate(self, prompts, max_new: int = 16, temperature: float = 0.0,
                 seed: int = 0, priorities=None) -> np.ndarray:
        """Prompts (a ``[B, plen]`` array, or a list of 1-D prompts of mixed
        lengths) -> ``[B, max_new]`` tokens through the serve engine;
        ``priorities`` optionally names a traffic class per prompt."""
        return self.engine(seed).generate(prompts, max_new, temperature,
                                          seed=seed, priorities=priorities)

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
