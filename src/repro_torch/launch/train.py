"""Training launcher for the port, on the card by default.

  python -m repro_torch.launch.train --arch paper-moe-100m --steps 50 \\
      --seq-len 1024 --global-batch 8 --reshape --fused

(with ``src`` on ``PYTHONPATH``).  ``--device cpu`` runs it on the CPU, at
a smoke size, for tests.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time


def build(args):
    """(TrainLoop, reshaper or None) for parsed ``args``."""
    from repro_torch.configs import get_arch
    from repro_torch.core.reshape_moe import MoEReshaper
    from repro_torch.core.skew import SkewParams
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWCfg
    from repro_torch.runtime.loop import LoopConfig, TrainLoop
    from repro_torch.runtime.train import TrainHyper

    cfg = get_arch(args.arch)
    if args.fused and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, fused_gating=True, fused_dispatch=True))
    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq_len,
                         global_batch=args.global_batch, seed=0,
                         class_alpha=args.class_alpha)
    hyper = TrainHyper(opt=AdamWCfg(lr=args.lr, warmup_steps=20,
                                    total_steps=max(args.steps, 100)))
    lc = LoopConfig(microbatches=args.microbatches,
                    ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir or os.path.join(
                        tempfile.gettempdir(), "repro_torch_train_ckpt"),
                    device=args.device)
    reshaper = None
    if args.reshape and lm.n_moe_layers(cfg):
        reshaper = MoEReshaper(cfg, lm.n_moe_layers(cfg),
                               ep_ranks=args.ep_ranks,
                               params=SkewParams(eta=0.0, tau=0.2))
    if args.resume:
        loop = TrainLoop.recover(cfg, stream, hyper, lc, reshaper=reshaper)
        print(f"recovered at step {int(loop.state['step'])}")
    else:
        loop = TrainLoop(cfg, stream, hyper, lc, reshaper=reshaper)
    return loop, reshaper


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-moe-100m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reshape", action="store_true",
                    help="enable Reshape expert-skew mitigation")
    ap.add_argument("--fused", action="store_true",
                    help="fused gating and dispatch (the kernels)")
    ap.add_argument("--class-alpha", type=float, default=1.5,
                    help="token-class Zipf skew (drives routing skew)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ep-ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (tests, smoke sizes)")
    args = ap.parse_args(argv)

    loop, reshaper = build(args)
    t0 = time.perf_counter()
    hist = loop.run(args.steps)
    dt = time.perf_counter() - t0
    for h in hist[:: max(1, len(hist) // 20)]:
        extra = ""
        if "dropped" in h:
            extra = f" dropped={int(h['dropped'].sum())}"
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.2f}{extra}")
    print(f"\n{len(hist)} steps in {dt:.1f}s "
          f"({len(hist) / max(dt, 1e-9):.2f} steps/s)")
    if reshaper is not None:
        print(f"reshape iterations: {reshaper.iterations}; "
              f"events: {len(reshaper.events)}")
    return hist


if __name__ == "__main__":
    main()
