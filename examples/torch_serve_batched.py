"""Continuous-batching serving on the PyTorch port: mixed-length requests
join and leave a slot pool, prefill runs in chunked batches, the tick's
composition is the Maestro min-FRT choice — and the stream answers
pause/inspect/update control messages MID-GENERATION, just like training.
On the card every tick replays a CUDA graph of the decode step.

  PYTHONPATH=src python examples/torch_serve_batched.py               # the card
  PYTHONPATH=src python examples/torch_serve_batched.py --device cpu  # the CPU

``--distill-steps`` sets the draft's distillation steps (the reference
example's 300 by default).
"""
import argparse
import dataclasses
import os
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import PriorityClass
from repro_torch.core import messages as M
from repro_torch.core.controller import Controller
from repro_torch.core.regions import Op, Workflow, schedule
from repro_torch.engine import (Engine, ServeEngine, distill_draft,
                                serve_tick_workflow, small_draft_cfg)
from repro_torch.launch import device
from repro_torch.models import lm
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime.serve import BatchedServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b-smoke",
                    help="the model of the sections after the first")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distill-steps", type=int, default=300)
    args = ap.parse_args(argv)
    dev = device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        return run(args.arch, dev, args.distill_steps, tmp)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(arch, dev, distill_steps, tmp):
    rng = np.random.default_rng(0)
    out = {}

    def init(cfg):
        return lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)

    # ---- throughput: continuous batching vs the old static loop ----------
    for name in ("yi-34b-smoke", "gemma3-1b-smoke", "rwkv6-1.6b-smoke"):
        cfg = get_arch(name)
        srv = BatchedServer(cfg, init(cfg), max_len=96, slots=4,
                            prefill_chunk=16, decode_chunk=8, device=dev)
        lens, news = [4, 12, 20, 28], [16, 8, 12, 6]
        prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
                   for n in lens]
        eng = srv.engine()
        reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
        eng.run_until_done()                      # warm (captures the graph)
        reqs = [eng.submit(p, max_new=n) for p, n in zip(prompts, news)]
        _sync(dev)
        t0 = time.time()
        eng.run_until_done()
        _sync(dev)
        dt = time.time() - t0
        print(f"{name:24s} mixed plens={lens} max_new={news} "
              f"-> {sum(news)} tokens in {dt:.2f}s "
              f"({sum(news) / dt:.1f} tok/s, {eng.tick_no} ticks, "
              f"jobs={eng.engine.jobs_run})")

    # ---- control plane mid-stream ----------------------------------------
    cfg = get_arch(arch)
    params = init(cfg)
    eng = ServeEngine(cfg, params, max_len=96, slots=2, prefill_chunk=8,
                      decode_chunk=2, device=dev)
    ctl = eng.engine.controller
    for i in range(4):
        eng.submit(rng.integers(1, cfg.vocab, (6 + 4 * i,)).astype(np.int32),
                   max_new=24)

    def user_session():
        while eng.tick_no < 2:                    # mid-generation
            time.sleep(0.001)
        print("\n[user] >> pause (mid-generation)")
        r = ctl.send(M.pause()).wait(60)
        print(f"[user] paused at tick {r['paused_at'][0]}")
        info = ctl.send(M.inspect()).wait(60)     # answered WHILE paused
        busy = [s for s in info["slots"] if s]
        print(f"[user] inspect while paused: tick={info['tick']} "
              f"queue={info['queue_depth']} slots={busy}")
        print(f"[user] engine costs: "
              f"{ {k: round(v, 4) for k, v in info['engine']['costs'].items()} }")
        print("[user] >> update max_prefill_defer=1 (hot reconfiguration)")
        ctl.send(M.update(max_prefill_defer=1)).wait(60)
        print("[user] >> resume")
        ctl.send(M.resume()).wait(60)

    th = threading.Thread(target=user_session)
    th.start()
    eng.run_until_done()
    th.join(60)
    print(f"\nstream finished under control: {eng.tokens_out} tokens over "
          f"{eng.tick_no} ticks; decisions tail: "
          f"{[d['choice'] for d in list(eng.engine.decisions)[-6:]]}")

    # ---- speculative in-tick decoding: the n-gram proposer ---------------
    # a per-slot n-gram suffix table drafts up to cfg.serve.spec_len tokens
    # a decode tick; the tick verifies them and commits the longest
    # accepted prefix (greedy outputs unchanged).  The arm is pinned on
    # here; left alone the engine decides from measured acceptance.
    eng = ServeEngine(cfg, params, max_len=160, slots=2, prefill_chunk=8,
                      decode_chunk=4, spec_decode=True, device=dev)
    _pin(eng, "spec:ngram")
    for _ in range(2):
        eng.submit(np.random.default_rng(1).integers(
            1, cfg.vocab, (8,)).astype(np.int32), max_new=48)
    eng.run_until_done()
    acc = eng.spec_accepted / max(eng.spec_proposed, 1)
    print(f"\nspeculative decode (ngram arm pinned on): {eng.spec_ticks} "
          f"spec ticks, acceptance={acc:.2f} ({eng.spec_accepted}/"
          f"{eng.spec_proposed} drafts); the auto decision from these "
          f"measurements would be: "
          f"{[d['choice'] for d in list(eng.engine.decisions)[-2:]]}; "
          f"accept EMA keys: "
          f"{[k for k in eng.engine.costs.snapshot() if 'accept' in k]}")

    # ---- speculative decoding: the draft-model proposer ------------------
    # a tiny independent draft decodes ahead of the target; distill_draft
    # trains it on the target's own greedy streams, and
    # update(draft_params=...) republishes a draft mid-stream: the target
    # verifies every position, so a wrong draft can only lower acceptance.
    # This engine logs its control messages durably: the swap's tensors on
    # the device go into the log and come back with their dtype and bits.
    dcfg = small_draft_cfg(cfg)
    train_prompts = [rng.integers(1, cfg.vocab, (8,)).astype(np.int32)
                     for _ in range(6)]
    t0 = time.time()
    dparams = distill_draft(cfg, params, dcfg, train_prompts, max_new=48,
                            steps=distill_steps)
    print(f"\ndistilled {dcfg.name} in {time.time() - t0:.1f}s")
    log_path = os.path.join(tmp, "serve_control.log")
    eng = ServeEngine(cfg, params, max_len=160, slots=2, prefill_chunk=8,
                      decode_chunk=4, spec_decode=True, draft_cfg=dcfg,
                      draft_params=dparams, device=dev,
                      engine=Engine(durable_log=log_path))
    _pin(eng, "spec:draft")
    for p in train_prompts[:2]:
        eng.submit(p, max_new=48)
    eng.run_until_done()
    st = eng.spec_arms.get("draft", {})
    print(f"draft arm: {st.get('ticks', 0)} spec ticks, acceptance="
          f"{st.get('accepted', 0) / max(st.get('proposed', 1), 1):.2f} "
          f"({st.get('accepted', 0)}/{st.get('proposed', 0)} drafts)")
    # hot-republish mid-stream: even a garbage draft cannot change outputs
    reqs = [eng.submit(p, max_new=24) for p in train_prompts[2:4]]
    eng.tick()
    eng.update(draft_params=tree_map(lambda x: -x, dparams))
    eng.run_until_done()                  # the next tick's poll swaps it
    st = eng.spec_arms["draft"]
    print(f"after garbage hot-swap: acceptance fell to "
          f"{st['accepted'] / max(st['proposed'], 1):.2f} cumulative — "
          f"throughput cost, never a correctness cost")
    want = BatchedServer(cfg, params, max_len=160, device=dev) \
        .generate_static(np.stack(train_prompts[2:4]), 24)
    out["garbage_unchanged"] = bool(np.array_equal(
        np.stack([r.output() for r in reqs]), want))
    print(f"outputs unchanged under the garbage draft: "
          f"{out['garbage_unchanged']}")
    rec = Controller.read_durable_log(log_path)
    w = rec[-1].payload["draft_params"]["embed"]
    print(f"durable log: {[(r.kind, r.step) for r in rec]}; the swap's "
          f"embed read back as {w.dtype} {tuple(w.shape)}, bit-equal: "
          f"{bool(torch.equal(w, (-dparams['embed']).cpu()))}")

    # ---- priority classes over multiple slot pools -----------------------
    # two traffic classes (interactive "hi" outweighs batch "lo" 8:1, lo's
    # prefills may sit out at most 4 scheduled ticks) over two slot pools;
    # the engine arbitrates every tick across both pools under weighted FRT
    # and the aging bound keeps lo starvation-free.
    cfg_prio = dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, classes=(PriorityClass("hi", 8.0, 6),
                            PriorityClass("lo", 1.0, 4))))
    eng = ServeEngine(cfg_prio, params, max_len=96, slots=2, pools=2,
                      prefill_chunk=8, decode_chunk=2, device=dev)
    lo = [eng.submit(rng.integers(1, cfg.vocab, (20,)).astype(np.int32),
                     max_new=24, priority="lo") for _ in range(2)]
    for _ in range(2):
        eng.tick()                        # batch load is mid-flight...
    hi = [eng.submit(rng.integers(1, cfg.vocab, (4,)).astype(np.int32),
                     max_new=8, priority="hi") for _ in range(2)]
    eng.run_until_done()
    print(f"\npriority serving: hi ttft="
          f"{[f'{(r.t_first - r.t_submit) * 1e3:.0f}ms' for r in hi]}, "
          f"lo max_deferred={[r.max_deferred for r in lo]} (bound 4); "
          f"last decisions: "
          f"{[d['choice'] for d in list(eng.engine.decisions)[-3:]]}")
    out["classes_served"] = {
        c: all(r.done.is_set() and len(r.output()) == r.max_new for r in rs)
        for c, rs in (("hi", hi), ("lo", lo))}
    print(f"both traffic classes served: {out['classes_served']}")

    # ---- cross-request prefix cache + result cache -----------------------
    # requests sharing a preamble: wave 1 prefills from scratch and
    # snapshots slot rows at prefill tick boundaries into a radix tree;
    # wave 2 seeds from the deepest cached prefix, so prefill shrinks to
    # the unique suffix.  An exact repeat never touches a slot: the result
    # cache answers it (greedy-only, params-versioned).
    eng = ServeEngine(cfg, params, max_len=96, slots=2, prefill_chunk=16,
                      decode_chunk=4, prefix_cache=True, device=dev)
    preamble = rng.integers(1, cfg.vocab, (32,)).astype(np.int32)

    def wave():
        rs = [eng.submit(np.concatenate(
            [preamble, rng.integers(1, cfg.vocab, (2,)).astype(np.int32)]),
            max_new=8) for _ in range(2)]
        eng.run_until_done()
        return rs

    wave()                                        # warm + build the tree
    w2 = wave()                                   # seeds from the snapshots
    repeat = eng.submit(np.concatenate([w2[0].prompt]), max_new=8)
    eng.run_until_done()                          # exact hit: no ticks run
    st = eng.prefix.stats()
    print(f"\nprefix cache: seeded={st['seeded']} admissions, "
          f"{st['tokens_avoided']} prefill tokens avoided, "
          f"snapshots={st['snapshots']}; exact repeat answered from the "
          f"result cache ({st['result_hits']} hit, "
          f"done={repeat.done.is_set()})")

    # ---- device-placed pools: elastic scale with live slot migration -----
    # each pool commits its rows to its own device group (on one device
    # both name it); drain_pool migrates in-flight slots with bit-identical
    # greedy continuations, zero requests dropped.
    placements = {0: [dev], 1: [dev]}
    eng = ServeEngine(cfg, params, max_len=96, slots=2, pools=2,
                      prefill_chunk=8, decode_chunk=4, placements=placements,
                      device=dev)
    reqs = [eng.submit(rng.integers(1, cfg.vocab, (6 + 2 * i,)).astype(
        np.int32), max_new=10, pool=i % 2) for i in range(4)]
    eng.run_until_done()                          # warm (both pools)
    reqs = [eng.submit(rng.integers(1, cfg.vocab, (6 + 2 * i,)).astype(
        np.int32), max_new=10, pool=i % 2) for i in range(4)]
    for _ in range(3):
        eng.tick()                        # requests mid-flight on both...
    eng.drain_pool(eng.pools[0].lid)      # ...scale pool 0 away, live
    eng.run_until_done()
    st = eng._inspect("status")["placement"]
    print(f"\ndevice-placed pools on {dev}: drained pool 0 mid-stream -> "
          f"migrated={st['migrated_slots']} slots, pools left="
          f"{[p.lid for p in eng.pools]}, parallel group ticks="
          f"{st['parallel_group_ticks']}; all "
          f"{sum(len(r.tokens) >= r.max_new for r in reqs)}/4 requests "
          f"finished")

    # ---- the Maestro region view the engine schedules with ---------------
    wf = serve_tick_workflow(decode_slots=2, decode_chunk=4,
                             prefill_tokens=64, t_token=0.01)
    print("\nserve-tick regions (Maestro):", [sorted(r) for r in schedule(wf)])
    wf2 = Workflow()
    for op in [Op("requests", "scan", 1.0, 1.0, 100),
               Op("prefill", "join", 5.0, 1.0),
               Op("decode", "op", 1.0, 16.0),
               Op("stream_out", "sink", 0.1, 1.0)]:
        wf2.add_op(op)
    wf2.add_edge("requests", "prefill", blocking=True, port="build")
    wf2.add_edge("prefill", "decode")
    wf2.add_edge("decode", "stream_out")
    print("serving pipeline regions:", [sorted(r) for r in schedule(wf2)])
    return out


def _pin(eng, arm):
    """Pin the decode arm on every decode tick past the engine's cost
    decision (for the demo; the engine decides from measured acceptance
    when left alone)."""
    choose = eng.engine.choose_serve_tick
    eng.engine.choose_serve_tick = lambda *a, **k: (
        arm if choose(*a, **k) == "decode" and k.get("spec_len", 0) > 1
        else choose(*a, **k))


if __name__ == "__main__":
    main()
