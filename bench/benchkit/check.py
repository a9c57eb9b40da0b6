"""Whether what the timed path served is correct: the plain reference's
verdict on a sample of the finished requests.

The sample, drawn from the seed, holds the finished request with the most
positions and others until it has ``served_tokens`` served tokens and
``min_requests`` requests (or ``max_requests`` requests).  The reference
runs once over each request's prompt and served tokens (teacher-forced)
and gives, for each served token, the gap by which the reference's logit
of that token lies below the reference's best at that position.  The
number compared is the widest gap (``logit_gap``), against the
configuration's limit (``check``).  Greedy serving of a
correct program only parts from the reference where two logits nearly
tie.

The control (``control_gap``) puts the reference in
the program's place at the step below the configuration's precision
(float8 e4m3 products, ``reference._plain.fp8_mm``) and reads, at the
same positions, the gap of the token the control puts first.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchkit.traffic import rng_for


def pick(recs, seed: int, served_tokens: int, min_requests: int,
         max_requests: int) -> List:
    """The sample: the finished request with the most positions, then
    others in an order drawn from the seed, until it holds
    ``served_tokens`` served tokens and ``min_requests`` requests, or
    ``max_requests``."""
    done = [r for r in recs if r.t_done is not None and r.phase != "ladder"
            and len(r.req.tokens) >= 2]
    if not done:
        return []
    done.sort(key=lambda r: (-(r.plen + len(r.req.tokens)), r.t_submit))
    out, rest = [done[0]], done[1:]
    order = rng_for(seed, "sample").permutation(len(rest))
    total = len(done[0].req.tokens)
    for i in order:
        if total >= served_tokens and len(out) >= min_requests or \
                len(out) >= max_requests:
            break
        out.append(rest[i])
        total += len(rest[i].req.tokens)
    return out


def sequences(sample):
    """(token sequences, the first position whose logits are judged, the
    served tokens) of each sampled request: its prompt and every served
    token but the last."""
    seqs, starts, served = [], [], []
    for r in sample:
        toks = np.asarray(r.req.tokens, np.int64)
        seqs.append(np.concatenate([np.asarray(r.item.prompt, np.int64),
                                    toks[:-1]]))
        starts.append(r.plen - 1)
        served.append(toks)
    return seqs, starts, served


def gaps(ref, cfg: Dict, weights, seqs, starts, served,
         control: bool = False) -> Dict[str, float]:
    """Over every served token: ``logit_gap``, the widest gap below the
    reference's best; with ``control`` the same of the control's first
    choices (``control_gap``)."""
    from reference._plain import f32_mm, fp8_mm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def reading(picks, name):
        g = torch.cat([b - x[torch.arange(len(t), device=x.device), t]
                       for x, b, t in zip(ref_l, best, picks)])
        return {name: float(g.max())}

    with torch.no_grad():
        ref_l = ref.logits(weights, seqs, starts, cfg, f32_mm)
        best = [x.max(-1).values for x in ref_l]
        out = reading([torch.as_tensor(t, device=x.device)
                       for t, x in zip(served, ref_l)], "logit_gap")
        if control:
            ctl = ref.logits(weights, seqs, starts, cfg, fp8_mm)
            out.update(reading([c.argmax(-1) for c in ctl],
                               "control_gap"))
    return out
