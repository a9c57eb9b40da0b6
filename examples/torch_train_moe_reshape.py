"""End-to-end driver of the PyTorch port: train the paper-technique
showcase MoE LM with live Reshape expert-skew mitigation under skewed
token traffic, printing the load balance and dropped-token trajectory
(the 'results shown to the user').

  PYTHONPATH=src python examples/torch_train_moe_reshape.py [--steps 300]
  PYTHONPATH=src python examples/torch_train_moe_reshape.py --device cpu --steps 20

By default it trains the reference example's ~8M-parameter reduction of
``paper-moe-100m`` (4 layers, d_model 128, vocab 2048, capacity factor
1.1); ``--arch paper-moe-100m`` trains a registry config as it is.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_arch
from repro_torch.configs.base import reduced
from repro_torch.core.reshape_moe import MoEReshaper
from repro_torch.core.skew import SkewParams
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import device
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWCfg
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from repro_torch.runtime.train import TrainHyper


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--no-reshape", action="store_true")
    ap.add_argument("--arch", default=None,
                    help="a registry config in place of the reduction")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device(args.device)

    if args.arch is None:
        cfg = reduced(get_arch("paper-moe-100m"), layers=4, d_model=128,
                      vocab=2048)
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.1))
    else:
        cfg = get_arch(args.arch)
    nl = lm.n_moe_layers(cfg)
    print(f"params ~{cfg.n_params() / 1e6:.1f}M  experts="
          f"{cfg.moe.num_experts} top-{cfg.moe.top_k}  device={dev}")

    stream = TokenStream(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0,
                         class_alpha=2.0)          # skewed token classes
    reshaper = None
    if not args.no_reshape:
        reshaper = MoEReshaper(cfg, n_moe_layers=nl, ep_ranks=2,
                               params=SkewParams(eta=0.0, tau=0.15),
                               phase1_steps=1)
    loop = TrainLoop(cfg, stream,
                     TrainHyper(opt=AdamWCfg(lr=1e-3, warmup_steps=30,
                                             total_steps=args.steps)),
                     LoopConfig(microbatches=2, device=str(dev)),
                     reshaper=reshaper)
    hist = loop.run(args.steps)

    for h in hist[:: max(1, len(hist) // 25)]:
        sc = h.get("slot_counts")
        lb = ""
        if sc is not None:
            per_rank = sc.reshape(sc.shape[0], 2, -1).sum(-1)
            lb = f"  rank_lb={per_rank.min() / max(per_rank.max(), 1):.2f}"
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"dropped {int(h.get('dropped', np.zeros(1)).sum()):5d}{lb}")

    first = np.mean([h["loss"] for h in hist[:10]])
    last = np.mean([h["loss"] for h in hist[-10:]])
    print(f"\nloss {first:.4f} -> {last:.4f}")
    if reshaper:
        print(f"reshape: {reshaper.iterations} mitigation iterations, "
              f"{len(reshaper.events)} events")
    return hist, reshaper


if __name__ == "__main__":
    main()
