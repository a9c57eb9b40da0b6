"""Quickstart of the PyTorch port: build a model from the registry, run one
train step and a few decode steps — the public API in ~50 lines.

  PYTHONPATH=src python examples/torch_quickstart.py                # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # the CPU
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import device
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.runtime.serve import BatchedServer
from repro_torch.runtime.train import TrainHyper, build_train_step, make_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b-smoke")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device(args.device)

    # 1. pick an architecture (any of the 11 ids, or *-smoke reductions)
    cfg = get_arch(args.arch)
    print(f"arch={cfg.name}  layers={cfg.num_layers}  "
          f"pattern={cfg.pattern[:6]}…  device={dev}")

    # 2. one training step (random weights from a torch.Generator)
    shape = ShapeCfg("demo", seq_len=32, global_batch=4, kind="train",
                     microbatches=2)
    state = make_state(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    step = build_train_step(cfg, shape, TrainHyper())
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 32)), device=dev)
    nl = lm.n_moe_layers(cfg)
    plan = moe_lib.identity_plan(cfg, nl, device=dev) if nl else (None,
                                                                  None)
    state, metrics = step(state, {"tokens": tokens}, *plan)
    print(f"loss={float(metrics['loss']):.3f}  "
          f"grad_norm={float(metrics['grad_norm']):.3f}")

    # 3. batched serving (prefill + decode with KV cache)
    srv = BatchedServer(cfg, state["params"], max_len=64, device=dev)
    prompts = np.random.default_rng(1).integers(1, cfg.vocab, (2, 8)).astype(
        np.int32)
    out = srv.generate(prompts, max_new=8, temperature=0.0)
    print(f"generated: {out.tolist()}")
    return out


if __name__ == "__main__":
    main()
