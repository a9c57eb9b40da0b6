#!/usr/bin/env python3
"""How far the tensor-parallel decode step parts from the unsplit step at
full width, and ``chip_smoke.py``'s ``[mesh]`` phase alone, on one NVIDIA
GPU.

    python3 scripts/mesh_probe.py [--reps N]

First ``paper-moe-100m`` (random bf16 weights from the smoke's seed) cut
to 1, 2, 4 and 8 layers: one decode step of ``models.tp`` at ``tp = 2``
(both shards on the card) against ``lm.decode_step`` from a fresh cache
on 4 random tokens, twice a depth: the largest |logit|, the largest and
mean logit difference, and the largest difference over the smoke's bound
``MESH_TP_TOL * (1 + |unsplit logit|)``.  Then ``[mesh]`` N times in the
process (2 by default; the first also captures its oracles), on prompts
of the ``[serve]`` lengths drawn from the smoke's seed, with its checks:
it prints the card's name and power limit, the phase's lines, and the
checks that failed.  It exits 1 if any did, 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def tp_depths(torch, cfg, params, dev) -> None:
    from repro_torch.models import lm, tp
    rng = np.random.default_rng(3)
    devs = [dev, dev]
    for depth in (1, 2, 4, 8):
        c = cs.cut(cfg, depth)
        p = cs.first_layers(params, c)
        shards = tp.split_params(p, c, 2, devs)
        with torch.no_grad():
            for trial in range(2):
                st = lm.init_cache(c, 4, 64, device=dev)
                caches = tp.init_cache(c, 4, 64, 2, devs)
                pos = torch.zeros(4, dtype=torch.long, device=dev)
                t = torch.as_tensor(rng.integers(1, c.vocab, (4, 1)),
                                    device=dev)
                l1, _ = lm.decode_step(p, st, t, c, moe_groups="row")
                l2, _ = tp.decode_step(shards, {"caches": caches,
                                                "pos": pos}, t, c, devs,
                                       moe_groups="row")
                a = l1.float()
                err = (a - l2.float()).abs()
                bound = cs.MESH_TP_TOL * (1 + a.abs())
                cs.log(f"[probe] depth {depth} trial {trial}: |logit| max "
                       f"{a.abs().max().item():.4f}; difference max "
                       f"{err.max().item():.6f}, mean "
                       f"{err.mean().item():.6f}; over the bound "
                       f"{(err / bound).max().item():.4f}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mesh_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.runtime.serve import BatchedServer, serving_params
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    print(cs.card(), flush=True)
    dev = torch.device("cuda")
    cfg = cs.moe_cfg()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(cs.SEED),
                     device=dev)
    srv = BatchedServer(cfg, params, max_len=cs.SERVE_MAX_LEN,
                        slots=cs.SERVE_SLOTS, device=dev)
    del params
    tp_depths(torch, cfg, serving_params(srv.params, dev), dev)
    fails = []
    oracle = cs.StaticOracle(torch, srv, fails)
    rng = np.random.default_rng(cs.SEED + 7)
    lens = cs.PROMPT_LENS
    prompts = [rng.integers(1, cfg.vocab, lens[i % len(lens)])
               .astype(np.int32) for i in range(cs.MIGRATE_REQS)]
    for rep in range(args.reps):
        t0 = time.perf_counter()
        cs.mesh_phase(torch, dev, cfg, srv, oracle, prompts, 0.0, fails)
        cs.log(f"[probe] [mesh] run {rep}: {time.perf_counter() - t0:.1f} s")
    print(f"failed checks: {fails}", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
