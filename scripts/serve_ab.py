#!/usr/bin/env python3
"""Serving and MoE gating on one NVIDIA GPU, for one tree of the port, so
that two trees can be compared in one machine, in turns.

    python3 scripts/serve_ab.py [--src DIR] [--tag NAME] [--ssm]

``--src`` is the ``src/`` directory whose ``repro_torch`` is measured
(default: this checkout's); its kernels build into that tree's own
``build/kernels``.  The run serves ``paper-moe-100m`` at full width as
``chip_smoke.py``'s ``[serve]`` main path does (random weights from seed
0, fused gating and dispatch, 8 slots, prompts of 16..128 tokens, 32 new
each, after a warm-up on the same server): wall, generated tok/s, and the
device's busy share from the same work under a CUDA-only trace over the
untraced wall.  It times the gating wrapper by CUDA-graph replay at the
serve shape ``[8, 1, 16]`` and the training microbatch's ``[1, 4096, 16]``
(k 2, random logits from seed 0).  With ``--ssm`` it also serves
``rwkv6-1.6b`` and ``zamba2-7b`` as ``chip_smoke.py`` does (4 prompts of
16..64 tokens, 16 new each, after a warm-up).  It prints the card's name
and power limit, then one JSON line.  It exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--ssm", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (MAX_NEW, PROMPT_LENS, SEED, SSM_NEW,
                            SSM_PROMPT_LENS, device_trace, graph_ms)
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_gating.moe_gating import gating_cuda
    from repro_torch.models import lm
    from repro_torch.runtime.serve import BatchedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build_all()
    out = {"tag": args.tag, "src": args.src}

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, shape in (("gating_serve_ms", (8, 1, 16)),
                        ("gating_train_ms", (1, 4096, 16))):
        logits = torch.randn(shape, generator=gen, device=dev)
        out[name] = graph_ms(torch, lambda: gating_cuda(logits, 2))

    base = get_arch("paper-moe-100m")
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, fused_gating=True, fused_dispatch=True))
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)
    srv = BatchedServer(cfg, params, max_len=max(PROMPT_LENS) + MAX_NEW + 32,
                        slots=len(PROMPT_LENS), prefill_chunk=16,
                        decode_chunk=4, device=dev)
    del params
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    srv.generate([p[:16] for p in prompts], 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = srv.generate(prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _, busy_us, _, _ = device_trace(
        torch, lambda: srv.generate(prompts, MAX_NEW))
    out.update(serve_wall_s=wall, serve_gen_tok_s=toks.size / wall,
               serve_device_us=busy_us, serve_busy=busy_us / 1e6 / wall,
               serve_ticks=srv.engine().tick_no)
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    if args.ssm:
        for arch in ("rwkv6-1.6b", "zamba2-7b"):
            cfg = get_arch(arch)
            params = lm.init(cfg, torch.Generator(device=dev).manual_seed(
                SEED), dtype=torch.bfloat16, device=dev)
            srv = BatchedServer(cfg, params,
                                max_len=max(SSM_PROMPT_LENS) + SSM_NEW + 16,
                                slots=4, prefill_chunk=16, decode_chunk=4,
                                device=dev)
            del params
            prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
                       for n in SSM_PROMPT_LENS]
            srv.generate([p[:16] for p in prompts], 4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = srv.generate(prompts, SSM_NEW)
            torch.cuda.synchronize()
            out[f"{arch}_gen_tok_s"] = toks.size / (time.perf_counter() - t0)
            del srv
            gc.collect()
            torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
