"""How much a one-ulp change of the Mamba2 scan's bf16 output moves a
training step's gradients on ``zamba2-7b`` at full width with random
weights, by depth.

The kernel step and the plain step of ``chip_smoke.py``'s ``[zamba2
train]`` differ in where they round: the chunked SSD kernel's bf16 y lies
within one ulp of the exact recurrence's, not on it.  This runs the port's
plain training step (``impl="torch"``, on the CPU) on the first ``n``
layers of ``zamba2-7b`` (f32 weights from seed 0, one row of ``--seq``
tokens), then the same step with every Mamba2 layer's y moved to a
neighbouring bf16 value at a quarter of its elements (seed 1), and prints
the worst relative L2 difference over the gradient leaves.  The random
weights amplify the change layer by layer, which is why ``chip_smoke.py``
holds the kernel step against the plain step on one mamba and one
shared_attn block rather than on a deeper cut.

    PYTHONPATH=src python scripts/scan_jitter_check.py --layers 1,3,5
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import blocks
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.train import TrainHyper, build_grad_step, make_state


def jittered(mamba2, gen):
    """``mamba2`` with each bf16 y moved by one ulp, up or down, at a
    quarter of its elements (the gradient passes through unchanged)."""
    def run(*args, **kw):
        y, h = mamba2(*args, **kw)
        yf = y.detach().float()
        ulp = torch.exp2(torch.floor(torch.log2(yf.abs().clamp_min(
            1e-30))) - 7)
        pick = (torch.rand(y.shape, generator=gen) < 0.25).float()
        sign = torch.where(torch.rand(y.shape, generator=gen) < 0.5, -1.0,
                           1.0)
        moved = (yf + pick * sign * ulp).to(y.dtype)
        return moved + (y - y.detach()), h
    return run


def worst_gap(n: int, seq: int) -> list:
    full = get_arch("zamba2-7b")
    cfg = dataclasses.replace(full, num_layers=n,
                              layer_pattern=full.pattern[:n])
    state = make_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, (1, seq)))
    grad = build_grad_step(cfg, TrainHyper(), "torch")[0]
    base = grad(state["params"], {"tokens": tokens}, None, None, 0)[0]
    plain = blocks.mamba2
    blocks.mamba2 = jittered(plain, torch.Generator().manual_seed(1))
    try:
        moved = grad(state["params"], {"tokens": tokens}, None, None, 0)[0]
    finally:
        blocks.mamba2 = plain
    return sorted((((a - b).float().norm() / b.float().norm()).item()
                   for a, b in zip(tree_leaves(moved), tree_leaves(base))),
                  reverse=True)[:3]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", default="1,3,5")
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()
    for n in (int(x) for x in args.layers.split(",")):
        print(f"{n} layers: the three worst gradient leaves' rel L2 with "
              f"y moved one bf16 ulp at a quarter of its elements: "
              f"{worst_gap(n, args.seq)}", flush=True)


if __name__ == "__main__":
    main()
