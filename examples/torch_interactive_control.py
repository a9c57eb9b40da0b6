"""Amber interactivity on the PyTorch port: pause a running training job,
inspect its state WHILE paused, hot-update the learning rate, set a
breakpoint, resume — then crash it and recover bit-exact from its last
checkpoint and the durable control-replay log.

  PYTHONPATH=src python examples/torch_interactive_control.py               # the card
  PYTHONPATH=src python examples/torch_interactive_control.py --device cpu  # the CPU

The run checkpoints every 6 of its 16 steps, so the crash after step 16
loses 4 steps: recovery restores step 12 and replays them, re-applying
the logged control messages at their (step, microbatch) points.
"""
import argparse
import tempfile
import threading
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core import messages as M
from repro_torch.core.breakpoints import GlobalCountBreakpoint
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import device
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from repro_torch.runtime.train import TrainHyper

STEPS, CKPT_EVERY = 16, 6


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b-smoke")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device(args.device)
    with tempfile.TemporaryDirectory() as ckpt:
        return run(args.arch, str(dev), ckpt)


def run(arch, dev, ckpt):
    cfg = get_arch(arch)

    def loop_cfg():
        return LoopConfig(microbatches=2, ckpt_every=CKPT_EVERY,
                          ckpt_dir=ckpt, device=dev)

    def stream():
        return TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=4,
                           seed=1)

    loop = TrainLoop(cfg, stream(), TrainHyper(), loop_cfg())
    ctl = loop.controller
    done = threading.Event()

    def user_session():
        while len(loop.history) < 2:             # let the job get going
            time.sleep(0.005)
        print("\n[user] >> pause")
        t0 = time.monotonic()
        r = ctl.send(M.pause()).wait(60)
        print(f"[user] paused at (step, microbatch)={r['paused_at']} "
              f"in {(time.monotonic() - t0) * 1e3:.0f} ms")
        info = ctl.send(M.inspect()).wait(60)     # responsive WHILE paused
        print(f"[user] inspect while paused: step={info['step']} "
              f"loss_tail={[round(h['loss'], 3) for h in info['history_tail']]}")
        print("[user] >> update lr_scale=0.3  (hot reconfiguration)")
        ctl.send(M.update(lr_scale=0.3)).wait(60)
        print("[user] >> set breakpoint: pause after 1,000 more tokens")
        ctl.send(M.set_breakpoint(GlobalCountBreakpoint(
            "token-budget", "tokens", target=1000))).wait(60)
        print("[user] >> resume")
        ctl.send(M.resume()).wait(60)
        # keep watching: when the token-budget breakpoint pauses the run,
        # resume it so training finishes
        while not done.is_set():
            if loop.hit_breakpoints and ctl.paused:
                print("[user] breakpoint hit -> resume to finish")
                ctl.send(M.resume()).wait(60)
                return
            time.sleep(0.005)

    th = threading.Thread(target=user_session)
    th.start()
    hist = loop.run(STEPS)
    done.set()
    th.join(60)
    print(f"\nran {len(hist)} steps; lr_scale now {loop.lc.lr_scale}; "
          f"breakpoints hit: {loop.hit_breakpoints}")
    print(f"control log: {[(r.kind, r.step, r.microbatch) for r in ctl.log]}")
    step_costs = {k: round(v, 4)
                  for k, v in loop.engine.costs.snapshot().items()
                  if k.startswith("train")}
    print(f"engine jobs: {loop.engine.jobs_run}; measured step costs (s): "
          f"{step_costs}")
    print(f"step-path decisions tail: "
          f"{[d['choice'] for d in list(loop.engine.decisions)[-5:]]} "
          f"(granulated while interactivity was live, fused while idle)")

    # ---- crash & recover --------------------------------------------------
    print("\nsimulating crash; recovering from checkpoint + control-replay "
          "log…")
    rec = TrainLoop.recover(cfg, stream(), TrainHyper(), loop_cfg())
    start = int(rec.state["step"])
    print(f"recovered at step {start}; replaying "
          f"{len(rec.controller._replay)} logged control messages…")
    rec.run(STEPS - start)
    match = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(loop.state["params"]), tree_leaves(rec.state["params"])))
    print(f"post-recovery params identical to uninterrupted run: {match}")
    return match


if __name__ == "__main__":
    main()
