#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together), prints each kernel's
   registers and spills, and fails unless every bf16 flash (12 kernels:
   forward, dK/dV and dQ at each of head dims 64, 112, 128 and 256),
   decode-attention (5: head dims up to 16, 32, 64, 128 and 256),
   Mamba2 SSD and RWKV6 chunk kernel, and every kernel of the scans' bf16
   backwards that multiplies (12: the Mamba2 and RWKV6 state and chunk
   kernels at state or head sizes 16, 32 and 64), issues tensor-core
   instructions (HMMA in its SASS) and spills nothing;
2. ``[serve]``: serves ``paper-moe-100m`` at full width (8 layers, d_model
   512, 16 experts + 2 spare slots, vocab 32000; random weights from a
   seed) with the fused gating and dispatch flags on, through
   ``BatchedServer.generate`` and so the ``ServeEngine``, whose tick
   replays a CUDA graph of the decode step (captured in a warm-up): 8
   prompts of mixed lengths 16..128, 32 new tokens each — the MoE main
   path, with every kernel's launch count set to 0 just before it and read
   just after (each replay credits the launches its capture recorded, and
   the counts must be exactly replays x that, none of the MoE kernels and
   the decode attention at 0, and the tick's graph holds
   as many gating kernel nodes as its capture counted); then the same
   work again under a CUDA-only ``torch.profiler`` trace, for the device's
   busy share of the untraced main path's wall time.  A trace gives times
   only: every launch count the run checks comes from ``LAUNCHES`` or from
   the kernel nodes of a CUDA graph of the work (``kernels.graphs``),
   which a capture cannot lose; a trace short of launch records is taken
   again, then logged with the records it lost and its times as partial;
3. ``[graph]``: a prefill tick and a decode tick through the graphed and
   the eager tick from the same state, logits, tokens, positions and
   caches equal bit for bit, and both ticks' host wall;
   ``[kernel]``: holds each MoE kernel against its plain torch version on
   the card, on the inputs of the decode step at the serve shape (integer
   outputs equal, float outputs within the stated tolerance), and times
   both, with CUDA-graph replay so the times are device times; gating also
   at E 128, k 8 over 4096 tokens;
4. ``[equiv]``: checks that greedy ``ServeEngine`` output equals
   ``generate_static`` token for token on a 4-row batch (4 rows never
   overflow a capacity of 4, so neither grouping drops an assignment);
5. on the same model at full width, 8 slots: ``[spec]`` serves 8 prompts
   of the ``[serve]`` lengths, each repeating an 8-token motif, 32 new
   tokens each, once per decode arm forced on every decode tick (plain,
   ``spec:ngram``, ``spec:draft`` with the truncated self-draft and with
   the target as its own draft) and once unforced: each equals
   ``generate_static``, the target draft accepts every proposal, and each
   MoE kernel's launches are exactly the replays of the tick's graph and
   of the draft's propose graph times their per-replay counts (counts set
   to 0 just before each run and read just after); ``[prefix]`` serves 16
   requests sharing a 96-token prefix with the prefix cache off and on
   (equal outputs, TTFT, seeded rows), then the same 16 again, all from
   the result cache with no tick; ``[publish]`` publishes a second seed's
   weights mid-stream with ``update(params=..., params_version=1)``: no
   request drops, later requests equal a fresh engine on the new weights
   through a graph captured again, and no version-0 answer or snapshot
   serves; these and the phases before run every tick at its pool's full
   height (``compact_decode=False``);
   ``[pools]``: 2 pools x 4 slots and a two-class table (interactive
   weight 4, aging bound 2; batch weight 1, bound 6; batch only on pool
   1), driven by ``loadgen.drive`` through ``BatchedServer.submit`` over
   the reference's ``priority_starvation`` and ``steady_poisson``
   scenarios (prompts scaled to 16-128 tokens): per class TTFT median and
   largest in virtual ticks and seconds, generated tok/s and
   ``max_deferred``, which must stay within its class's bound plus one
   (the tick the second pool waits when both pools age at once); every
   output equal to ``generate_static`` on 4 copies of its prompt (the
   oracle, ``[spec]``'s too: that loop's step captured once in a CUDA
   graph and replayed a token, 4 requests a batch each at its own
   position, held to the eager ``generate_static`` on the run's first 2
   requests token for token); every
   MoE launch one that a replay of a pool's graph made (counts set to 0
   just before each drive and read just after); per pool its graphs'
   captures and replays; the device's busy share under a CUDA-only trace;
   ``[compact]``: 8 slots, 2 requests decoding, forced full, forced
   compact (2-row ticks) and unforced, launch counts held the same way,
   each layout's per-token tick EMA and ``Engine.choose_compact``'s
   choice; the full run equal to ``generate_static``, a compact run equal
   to it except from a token where the static loop's top-2 margin is
   within the logit difference measured between the heights (cuBLAS
   rounds rows by the product's height); then 4 requests ending at
   different times (compact ticks of 4, 2 and 1 rows) held the same way;
   ``[autotune]``: the ``[pools]`` scenarios with ``autotune=True``, the
   knob moves and where they ended, outputs equal to ``generate_static``;
   ``[migrate]``: 12 requests on the ``[pools]`` server, pool 0 drained
   while pool 1 is full and a pool joined the next tick (captured on first
   use): every output equal to ``generate_static`` on 4 copies, none
   dropped, at least one slot migrated, pools 1 and 2 left, no graph of
   pool 0 left and pool 0 freed, every MoE launch a replay (or the new
   pool's capture's eager warm-up step), per pool; each migration batch's
   time against its bytes bound, the new pool's first serve, the memory
   around pool 0's retirement;
   ``[placed]``: the ``[pools]`` server with both pools placed on the card
   (``placements={0: "cuda:0", 1: torch.device("cuda", 0)}``), 8 of the
   ``[migrate]`` prompts, 12 new tokens each, pool 0 drained once a pool-0
   request has emitted a token and a placed pool joined the next tick
   (``add_pool(placement=[torch.device("cuda", 0)])``): every output the
   first 12 tokens of ``[migrate]``'s ``generate_static`` (greedy), none
   dropped, at least one slot migrated, pools 1 and 2 left and placed, an
   ``admission_pool`` decision and a candidate with ``load`` > 0, every
   placed pool reading the engine's weight tensors (the same
   ``data_ptr``s) and the engine and its placed weights allocating no
   more than the pools' rows and the tick's routing plan, every MoE launch
   a replay (or a capture's warm-up step); then the same requests with the
   two pools given distinct device-group keys on the one card, a stand-in
   for two cards whose overlap it does not measure: parallel group ticks
   ran, every output the oracle's;
   ``[mesh]``: pools over a device group that names the card twice
   (``["cuda:0", "cuda:0"]``), on the same model and 8 of the prompts:
   a. a 4-slot pool split 2 + 2 over it, a 2-slot pool's two requests
   migrating into it and, once its second shard has ticked, its in-flight
   slots migrating out into a joined 2-slot pool (every tick 2 rows high):
   every output equal to ``generate_static`` on 2 copies (the graphed
   oracle below at 2 rows), both shards' graphs replayed, every MoE
   launch a replay's (or a capture's warm-up step), the shards reading
   the engine's weight tensors and the live tensors' requested bytes
   growing by the rows and the routing plan only, tok/s beside
   ``[placed]`` a's; b. a 4-slot pool at ``pool_tp = 2`` (rows split by
   heads, ``models.tp``'s step a ``StagedStep``: one CUDA graph per TP
   shard and stage, each on its shard's device, the exchanges' copies
   between them outside every graph): the stage and graph counts per
   shard, the TP step's logits through the stage graphs equal to the
   eager staged step's bit for bit and within atol = rtol = 2e-2 of the
   unsplit step's, each of 8 steps from the unsplit step's state, each
   TP layer from the unsplit layer's input within that bound of it (the
   difference along the TP pool's own state logged),
   outputs equal to the 4-row oracle except from a token where its top-2
   margin is within what that bound lets the two logits move, the TP MoE
   layer's integers equal to the unsplit layer's on one input, the step's
   time by replay beside the TP step captured whole in one graph and the
   unsplit step's, each shard's weight bytes, tok/s, every launch a stage graph's
   replay (read from its kernel nodes, kernels 1-3 in shard 0's stages
   only); the MoE kernels on the TP pool's rows against their plain
   versions (``@tp``); a and b within 40 s; c. ``starcoder2-7b`` at its
   published widths and depth in a 2-slot pool at ``pool_tp = 2``, the
   same checks and numbers (no MoE; the whole step's logits within 5.4308
   times the bound, MESH_C_STEP_LIMIT), held to its own 2-row static
   loop, within 60 s;
   the MoE kernels also on inputs at compact heights 1 and 2 and on pools
   1's and 2's rows and a placed pool's, against their plain versions;
6. ``[train]``: first ``adamw.apply_`` (in place) against ``adamw.apply``
   bit for bit over 5 steps on ``paper-moe-100m``'s f32 tree; then trains
   ``paper-moe-100m`` at full width with ``TrainLoop``
   (fused gating and dispatch, ``MoEReshaper`` closing the Reshape loop,
   a skewed ``TokenStream``, global batch 8 x 1024 in 2 microbatches):
   first, from the initial state, one step through the kernels against
   the same step through the plain versions (the integer load metrics,
   the loss and every gradient leaf, the plain step replaying the kernel
   step's expert choices; and against the plain MoE kernels alone, the
   attention kernel in both arms, exactly), the granulated step against
   the fused one, and the kernel step run twice; ``build_train_step``
   (the production step) against the fused step from the same state
   (loss, integer metrics, each parameter's change under AdamW settings
   that make it the clipped gradient) and a fused step under
   ``remat="dots"`` against ``"none"``, parameters and metrics bit for
   bit, with their launches (the forward kernels twice under a remat
   policy); then a warm-up step and 6 steps of the main path, each
   step's kernel launches checked against what the code predicts, one
   more step under a CUDA-only trace, and the
   MoE kernels against their plain versions on the inputs of the warm-up
   step's last calls (dispatch and combine as each other's backward);
7. ``[flash]``: the flash-attention forward and backward kernels against
   their plain version (and an f32 oracle) at the training shape,
   ``zamba2-7b``'s shared-attention shape, a ragged length and head dim 256
   over a window of 1024 (``gemma3-1b``'s local attention); the forward
   timed at the training and ``zamba2-7b`` shapes and at head dim 16
   (``distill_draft``'s draft) beside ``scaled_dot_product_attention``,
   the backward at the training shape and at head dim 16 beside aten's
   flash-attention backward, all by CUDA-graph replay;
   ``[decode_attn]``: the split-KV decode-attention kernel at ``yi-34b``'s
   decode shape (8 rows, 56 query heads over 8 KV heads, hd 128, a cache
   of 3088 positions; the rows at mixed positions on and off the split
   boundaries, then every row at context 256, 1024 and 3088) against its
   plain version within ``tests/test_torch_decode_attention.py``'s bound,
   timed by CUDA-graph replay over enough distinct caches that none stays
   in the 50 MB L2 (as a step meets each layer's cache), beside its byte
   bound, the plain version over the whole cache and
   ``scaled_dot_product_attention`` over the context (``enable_gqa``;
   the library yardstick only);
8. ``[control]``: the Amber control plane on the card.  a. 4 requests
   (prompts of 16-50 tokens, 64 new each) on a 4-slot engine of
   ``paper-moe-100m`` at full width and depth; a thread pauses it mid-
   generation, inspects it while paused, updates ``decode_chunk`` and
   ``max_prefill_defer`` and resumes: the tokens equal an uninterrupted
   run's, and the pause latency prints in ticks and ms; b. the same
   requests with the draft arm forced and a durable log: a token budget
   that fires (a thread resumes it) and ``update(draft_params=...)``
   carrying the draft negated as bf16 tensors on the card, logged at tick
   2; the log reads back the tensors bit for bit, the tokens equal the
   plain run's, and after a "crash" a ``ReplayingController`` on a fresh
   engine replays both at their ticks, the budget pauses at the same tick
   and the tokens are bit-identical; every launch of a and b is one that
   a replay of the engines' graphs (or a capture's warm-up step) made,
   and each graph's MoE kernel nodes equal its per-replay counts; c. the
   model at full width and 2 of its 8 layers (4 x 256 tokens in 2
   microbatches): a run of 6 steps and a run with async checkpoints every
   2 steps that crashes after step 5, each with a thread's pause, inspect,
   ``lr_scale`` update and resume at (4, 0); recovery from step 4 and the
   durable log gives the uninterrupted run's parameters bit for bit;
   snapshot, persist, a step with and without a persist in flight, and
   the recovery wall (restore + replay) print; the recovered run again
   under ``torch.use_deterministic_algorithms(True)`` (the op that raises,
   if any) and with ``warn_only`` (the ops it names, and whether the
   params still equal); d. one ``Engine`` under the recovered loop and a
   ``ServeEngine``: its ``jobs_run`` and step-path decisions; each
   training sub-step launches exactly what the code predicts;
9. ``[rwkv6]`` and ``[zamba2]``: for ``rwkv6-1.6b`` (24 layers, d_model
   2048, 32 heads of 64, vocab 65536) and ``zamba2-7b`` (81 layers: 68
   Mamba2 and 13 occurrences of one shared attention block, d_model 3584,
   112 SSM heads), at full width with random bf16 weights from the seed:
   ``lm.forward`` on ``[4, 1024]`` / ``[2, 1024]`` tokens, the main path
   (launch counts reset just before it and read just after: exactly one
   scan launch per recurrent layer, and on the device one kernel node of
   each scan kernel a layer in a CUDA graph of the forward), then again
   under a CUDA-only trace for its device time by kernel; the scan kernel
   against its plain
   version on one layer's inputs captured from that forward, timed like the
   MoE kernels; forward against step-by-step decode on ``[2, 128]``;
   ``BatchedServer.generate`` on 4 prompts of 16..64 tokens (after a
   warm-up that captures the tick's graph); greedy
   ``ServeEngine`` against ``generate_static`` on ``[4, 32] + 16``.  Each
   model is freed before the next.  After each, ``[rwkv6 train]`` and
   ``[zamba2 train]``: ``train_compare`` (the kernel step against the
   plain one, granulated against fused, the kernel step against a repeat
   of itself bit for bit) on 2 x 128 tokens of two full-width blocks
   (rwkv6's two ``rwkv``; zamba2's one ``mamba`` and one ``shared_attn``),
   then ``TrainLoop`` on 2 x 1024 tokens in 2 microbatches (rwkv6 at all
   24 layers, zamba2 at 30 of 81): a warm-up step, whose last scan
   backward call's inputs and dy are kept, and 3 steps of the main path,
   each launching one forward and one backward scan per recurrent layer
   and microbatch (and flash's forward and backward per shared_attn
   occurrence); the scan backward kernel against its plain backward on
   those inputs, timed by graph replay; one more step under a CUDA-only
   trace gives a step's device time, each backward kernel's by name, and
   torch's bf16 add and fill kernels beside those of the step before each
   block type's layers were taken with one ``unbind`` a forward (a zero
   fill and an add of the whole stack per layer); then a ``TrainLoop`` under ``remat="full"`` from
   the same initial state: its first step's parameters equal the first
   loop's first step's bit for bit, its second step launches the forward
   kernels twice, with its wall and its peak beside the dry run under
   ``"full"``;
10. ``[gemma3]``: ``gemma3-1b`` at full width (26 layers: 22 ``local``
   over a sliding window of 1024 keys with a rolling decode cache and 4
   ``attn``; d_model 1152, 4 heads of 256 with one KV head, d_ff 6912, a
   tied vocab of 262144; about 1.0 B parameters, random bf16 weights from
   the seed): a. ``lm.forward`` on ``[2, 2048]`` tokens, the main path,
   exactly 26 ``flash_fwd`` launches (counts set to 0 just before and read
   just after; and 26 of its hd-256 kernel's nodes in a CUDA graph of the
   forward), then under a CUDA-only trace; b. the hd-256 flash forward
   and backward against their plain version on the last local layer's
   inputs captured from that forward, timed by graph replay beside
   ``scaled_dot_product_attention`` with the window as a boolean mask (and,
   for the record, causal only); c. forward vs step-by-step decode on
   ``[2, 128]``; d. each block type's last layer, forward vs decode at 1100
   tokens, so the ring wraps; e. ``BatchedServer.generate`` on 4 prompts
   of 16..1040 tokens after a warm-up that captures the tick's graph,
   exactly one ``decode_attn`` launch a layer and replay; f.
   greedy ``ServeEngine`` against ``generate_static`` on ``[2, 1040] +
   16`` at the first 7 layers (6 ``local``, 1 ``attn``); g. ``TrainLoop``:
   one microbatch through the kernels against the
   plain versions, then 3 steps of 2 x 2048 tokens in 2 microbatches, each
   step launching 52 ``flash_fwd`` and 52 ``flash_bwd``.  Each step and
   each phase logs its wall time;
11. the reference's last six configs at their published widths, random
    bf16 weights drawn on the card from the seed, each forward the main
    path of its phase (a warm-up, then the run counted from 0, then again
    under a CUDA-only trace for its busy share and device time by kernel),
    each serve through ``BatchedServer`` on the graphed tick (counts from
    0: replays x per-replay counts) held to ``generate_static`` on batches
    of one prompt length, and each model freed before the next:
    ``[olmoe]`` ``olmoe-1b-7b`` (16 layers, d_model 2048, 64 experts + 16
    spare slots top-8, the fused gating and dispatch): 8 prompts of 16 and
    128 tokens on 8 slots, 16 new each (the oracle on batches of 8 rows
    at a capacity at which nothing drops and its expert products have the
    engine's rows); the MoE kernels at k 8 over
    80 slots against their plain versions on the serve tick's and the
    forward's inputs (``gating_kernel<32, 2>``); the forward on ``[4,
    1024]``; the ``moe`` block's forward vs decode; then ``[olmoe train]``:
    ``train_compare`` at 2 of 16 layers, then 3 ``TrainLoop`` steps of 4 x
    1024 with ``MoEReshaper`` at 4 of 16 layers (the step updates its state
    in place), each step's launches checked; ``[ep]``: one olmoe MoE layer
    at full width on the forward's 4096 tokens with its experts over 2
    ranks on the one card (processes in a gloo group over CUDA tensors),
    ``moe_ffn_sharded`` against the unsharded ``moe_ffn`` (integers equal,
    y within 2e-2), each rank's launches (the dispatch with a ``valid``
    mask false on the other rank's slots), the bytes it handed to
    collectives beside ``analysis.flops``', the MoE kernels against their
    plain versions on rank 0's inputs; then the all-to-all layout on the
    same layer (``moe_ffn(..., layout="dp")``: 2048 tokens a rank,
    bucketed by destination rank with the dispatch kernel, exchanged with
    ``all_to_all``, combined at the source with the combine kernel) at a
    capacity where nothing drops, against the unsharded layer (integers
    equal, y within one bf16 ulp at its scale), with the bytes each rank
    handed to ``all_to_all`` beside the analytic a2a term; then one
    ``build_train_step`` step of ``paper-moe-100m`` at full width (8 x
    1024 in 2 microbatches, a capacity factor at which nothing can drop)
    over data 2 x model 1 and data 1 x model 2 in both layouts, each rank
    with its share of each microbatch and its slots, against the
    unsharded step: the loss, each parameter's change, the integer
    metrics, every rank's replicated leaves bit for bit, and each rank's
    collective bytes; ``[qwen3moe]``
    ``qwen3-moe-235b-a22b`` at 6 of 94 layers (128 experts + 16 spare
    slots top-8, q dim 8192 against d_model 4096): the forward on ``[2,
    1024]`` (``gating_kernel<32, 4>``; the flash kernel at hd 128 with 16
    query heads a KV head), the MoE kernels over 144 slots at D 4096 on the
    forward's and the serve tick's inputs, 4 prompts served on 4 slots;
    ``[dense]`` ``starcoder2-7b`` (all 32 layers), ``yi-34b`` (16 of 60)
    and ``command-r-plus-104b`` (8 of 64): the forward on ``[1, 2048]``, 2
    prompts served on 2 slots; ``[qwen2vl]`` ``qwen2-vl-7b`` (all 28
    layers, M-RoPE): the forward on ``[2, 1024]`` whose first 256
    positions are a 16 x 16 patch grid's (t, h, w) ids, against the plain
    versions' forward, 4 prompts served; ``[whisper]`` ``whisper-base``
    (6 encoder and 6 decoder layers): ``encode`` on ``[4, 1500, 512]``
    frames, the forward on 448 tokens (18 flash launches: 6 encoder, 6
    causal self, 6 cross), ``decode_step`` against the precomputed cross
    K/V vs the forward within the reference's atol 0.15 and rtol 0.1, one
    training microbatch through the kernels vs the plain versions and 3
    ``TrainLoop`` steps, and the non-causal flash forward and backward on
    the encoder's and the cross-attention's captured inputs against their
    plain version, timed beside ``scaled_dot_product_attention`` and aten's
    flash backward;
12. after every forward and training step it times: ``[mfu]``, the
    model FLOPs of ``analysis.flops.step_flops`` over the wall time and
    989e12 FLOP/s, and the wall against the roofline's least time
    (``analysis.roofline``, the H100's constants), with the card's name and
    power limit; ``[dryrun]``, the meta dry run's bytes for the same step
    on one card (``launch.dryrun``) beside the peak device memory measured
    over it;
13. prints the kernels' JSON line, the card's name and power limit, and
    last ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA device or without
the repository's ``src/`` beside it.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM published peaks (dense): HBM bytes/s, f32 CUDA-core FLOP/s and
# bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

SEED = 0
PROMPT_LENS = (16, 24, 37, 50, 64, 81, 100, 128)
MAX_NEW = 32

# The recurrent families at full width: the forward's batch (of FWD_LEN
# tokens each), the block type whose every layer launches the scan kernel
# once, and the logit tolerance within which the reference holds its own
# forward against its decode (tests/test_serve_consistency.py).
SSM_PHASES = (
    dict(tag="rwkv6", arch="rwkv6-1.6b", batch=4, block="rwkv",
         kernel="rwkv6_scan", atol=0.08),
    dict(tag="zamba2", arch="zamba2-7b", batch=2, block="mamba",
         kernel="mamba2_ssd", atol=0.25),
)
BLOCK_TOL = 2e-2                # one block, forward vs decode (bf16)
FWD_LEN = 1024
EQUIV_FWD = (2, 128)            # forward vs step-by-step decode
SSM_PROMPT_LENS = (16, 29, 45, 64)
SSM_NEW = 16
SSM_STATIC = (4, 32)            # greedy engine vs static loop, + SSM_NEW

# [gemma3]: gemma3-1b at full width.  The forward's [B, S] (twice the
# window, so the window masks); forward vs decode; the block check's length
# (past the window, so the rolling cache wraps); the served prompts (one
# past the window) and their new tokens; engine vs static on prompts that
# cross the window (as many rows as the engine has slots: cuBLAS rounds a
# product by its row count); training's global batch, sequence and
# microbatches (each microbatch [1, 2048]) and steps; the logit tolerance of
# tests/test_serve_consistency.py for gemma3
GEMMA_FWD = (2, 2048)
GEMMA_BLOCK_LEN = 1100
GEMMA_PROMPT_LENS = (16, 200, 600, 1040)
GEMMA_NEW = 16
GEMMA_STATIC = (2, 1040)
# step f's depth: its eager generate_static took 49-54 s of the run at all
# 26 layers and 28.4 s at 13 on an H100 80GB HBM3 at 700 W; the first 7
# hold 6 local and 1 attn layer, so the ring still wraps in both block
# types
GEMMA_STATIC_LAYERS = 7
GEMMA_TRAIN = (2, 2048, 2)
GEMMA_STEPS = 3
GEMMA_ATOL = 0.08


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S
             ) -> tuple:
    """The least time for the work: bytes over the memory rate or
    operations over the peak ``rate`` for their type, the larger."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


@functools.lru_cache(maxsize=1)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def step_shape(kind, batch, seq, mb=1):
    from repro_torch.configs import ShapeCfg
    return ShapeCfg(f"{kind} [{batch}, {seq}]", seq, batch, kind, mb)


def mfu_line(tag, cfg, kind, batch, seq, wall, mb=1, remat="none") -> None:
    """``[mfu]``: a timed forward (``prefill``) or training step's model
    FLOPs (``analysis.flops.step_flops``) over its wall time and the bf16
    peak (the step's recompute under ``remat`` is not model FLOPs: it is in
    the FLOPs the step runs), and the roofline's least time for it
    (``analysis.roofline`` on one card) over that wall."""
    from repro_torch.analysis import flops, roofline
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16
    shape = step_shape(kind, batch, seq, mb)
    fc = flops.step_flops(cfg, shape, remat)
    rl = roofline.analyze(cfg, shape, {"data": 1, "model": 1}, remat=remat)
    log(f"[mfu] {tag} {shape.name}: model FLOPs {fc.model_flops:.6g} (the "
        f"step runs {fc.hlo_flops:.6g} with remat {remat}), wall "
        f"{wall:.4f} s: mfu "
        f"{fc.model_flops / (wall * PEAK_FLOPS_BF16):.4f} of "
        f"{PEAK_FLOPS_BF16:.4g} FLOP/s; roofline (compute "
        f"{rl.compute_s:.4g} s, memory {rl.memory_s:.4g} s) "
        f"{rl.bound_s:.4g} s, bound by {rl.dominant}: the step runs at "
        f"{rl.bound_s / wall:.4f} of its roofline (analytic fraction "
        f"{rl.roofline_fraction:.4f}); {card()}")


def dry_line(torch, tag, cfg, kind, batch, seq, peak, mb=1, remat="none"):
    """``[dryrun]``: the meta dry run's bytes on one card for this step
    (``launch.dryrun``, a training step under ``remat``) beside the peak
    device memory measured over it.  Returns predicted / measured."""
    from repro_torch.launch import dryrun
    from repro_torch.runtime.sharding import parse_mesh
    t0 = time.perf_counter()
    rec = dryrun.dry_cell(cfg, step_shape(kind, batch, seq, mb),
                          [parse_mesh("1x1")], remat)[0]
    b = rec["bytes_per_device"]
    gib = {k: round(v / 2 ** 30, 3) for k, v in b.items()}
    ratio = b["total"] / max(peak, 1)
    log(f"[dryrun] {tag} {kind} [{batch}, {seq}] in {mb} microbatches, "
        f"{cfg.num_layers} layers, remat {remat}: predicted {gib['total']} "
        f"GiB ({gib}), measured peak {peak / 2 ** 30:.3f} GiB "
        f"(predicted/measured {ratio:.4f}; the aim 0.80-0.97); traced on "
        f"meta in {time.perf_counter() - t0:.2f} s")
    return ratio


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_mma_kernel<64>`` from a mangled kernel name (a
    length-prefixed identifier ending in ``_kernel``, then its template
    arguments)."""
    import re
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):
            ident = mangled[m.end():m.end() + int(digits[i:])]
            if ident.endswith("_kernel") and ident[0].isalpha():
                arg = re.match(r"ILi(\d+)E", mangled[m.end() + len(ident):])
                return ident + (f"<{arg.group(1)}>" if arg else "")
    return mangled[:60]


# bf16 kernels that must issue tensor-core instructions (HMMA in their
# SASS), by library: the names that mark them and how many there are (one
# per head dim or state size); none of them may spill
TENSOR_CORE_KERNELS = {
    "flash_attention": (("_mma_kernel",), 12),
    "mamba2_ssd": (("mamba2_ssd_state_kernel", "mamba2_ssd_scan_kernel"),
                   8),
    "rwkv6_scan": (("rwkv6_scan_chunk_kernel",), 4),
    "mamba2_ssd_bwd": (("mamba2_ssd_bwd_state_kernel",
                        "mamba2_ssd_bwd_chunk_kernel"), 6),
    "rwkv6_scan_bwd": (("rwkv6_scan_bwd_state_kernel",
                        "rwkv6_scan_bwd_chunk_kernel"), 6),
    "decode_attention": (("decode_attn_kernel",), 4)}
NO_SPILLS = tuple(m for marks, _ in TENSOR_CORE_KERNELS.values()
                  for m in marks)


def build_report(build) -> None:
    """Each kernel's registers and spills (ptxas) and, for the libraries of
    TENSOR_CORE_KERNELS, each kernel's tensor-core instructions (HMMA in
    the SASS); fails if a bf16 kernel issues none or spills."""
    import re
    import shutil
    spilled = []
    for src, text in build.PTXAS_LOG.items():
        name = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, spill, nbytes = _kernel_name(m.group(1)), "", 0
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = f", spill stores {m.group(1)} B, loads {m.group(2)} B"
                nbytes = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                log(f"[build] {src}: {name}: {m.group(1)} registers{spill}")
                if nbytes and any(k in name for k in NO_SPILLS):
                    spilled.append(name)
    if spilled:
        raise AssertionError(f"bf16 kernels that spill: {spilled}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, (marks, count) in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run(
            [tool, "-sass", str(build.build_dir() / f"lib{lib}.so")],
            capture_output=True, text=True, check=True).stdout
        hmma, name = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                name = _kernel_name(line.split("Function :")[1].strip())
                hmma.setdefault(name, 0)
            elif name and "HMMA" in line:
                hmma[name] += 1
        log(f"[build] {lib} SASS, HMMA instructions by kernel: "
            f"{dict(sorted(hmma.items()))}")
        bf16 = {n: c for n, c in hmma.items() if any(k in n for k in marks)}
        if len(bf16) != count or min(bf16.values()) == 0:
            raise AssertionError(f"bf16 {lib} kernels without tensor-core "
                                 f"instructions: {bf16}")


def graph_ms(torch, fn, reps: int = 50) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed between two events (no host launch gaps)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def capture_kernel_inputs(torch, run, targets=None, clone=True):
    """Run ``run()`` with the kernel wrappers wrapped so that each keeps its
    last call's arguments (copies, or with ``clone=False`` the tensors
    themselves, for callers whose inputs are never written again).
    ``targets`` are (module, wrapper name) pairs, by default the MoE
    kernels'.  Returns ``(run()'s result, {wrapper name: args})``."""
    if targets is None:
        targets = moe_targets()
    seen = {}
    originals = [getattr(m, n) for m, n in targets]

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] = tuple(a.clone() if clone and torch.is_tensor(a)
                               else a for a in args)
            return fn(*args, **kwargs)
        return wrapped

    for (m, n), fn in zip(targets, originals):
        setattr(m, n, recorder(n, fn))
    try:
        out = run()
    finally:
        for (m, n), fn in zip(targets, originals):
            setattr(m, n, fn)
    return out, seen


def compare_outputs(name, got, ref, n_int, tol):
    """The first ``n_int`` outputs equal, the rest within ``tol``; returns
    the largest float error."""
    for a, b in zip(got[:n_int], ref[:n_int]):
        if not a.equal(b):
            raise AssertionError(f"{name}: integer outputs differ")
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got[n_int:], ref[n_int:]))
    if err > tol:
        raise AssertionError(f"{name}: max |err| {err} > {tol}")
    return err


def gating_row(torch, logits, k, launches, name="moe_gating"):
    """The gating kernel against its plain version on ``logits`` [G,T,E]:
    ids and phi exact, weights within 1e-6 (the kernel sums the softmax
    denominator in another order, so weights may differ by ulps); both
    timed.  Returns the kernels JSON row."""
    from repro_torch.kernels.moe_gating.moe_gating import gating_cuda
    from repro_torch.kernels.moe_gating.ref import gating_ref
    g_, t_, e_ = logits.shape
    w, ids, cnt = gating_cuda(logits, k)
    rw, rids, rcnt = gating_ref(logits, k)
    err = compare_outputs(name, (ids, cnt, w), (rids, rcnt, rw), 2, 1e-6)
    nb = 4 * (g_ * t_ * e_ + 2 * g_ * t_ * k + g_ * e_)
    b_ms, b_by = bound_ms(nb, g_ * t_ * e_ * (5 + 2 * k))
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gating.cu",
        replaces="src/repro/kernels/moe_gating/moe_gating.py:18",
        launches=launches, max_abs_err=err,
        ms=graph_ms(torch, lambda: gating_cuda(logits, k)),
        plain_ms=graph_ms(torch, lambda: gating_ref(logits, k)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_kernels(torch, seen, launches):
    """Kernel vs plain version on the captured inputs; returns the rows of
    the kernels JSON line and the shapes each kernel ran at.  Raises on a
    mismatch."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_dispatch.moe_dispatch import (combine_cuda,
                                                               dispatch_cuda)
    from repro_torch.kernels.moe_dispatch.ref import combine_ref, dispatch_ref
    rows, shapes = [], {}
    compare = compare_outputs

    logits, k = seen["gating_cuda"]
    rows.append(gating_row(torch, logits, k, launches["moe_gating"]))
    shapes["moe_gating"] = {"logits": list(logits.shape), "k": k,
                            "tol": 1e-6}

    # dispatch: rank/keep/routed/kept exact; the buffer exact (one f32
    # product rounded once, in both)
    v, wd, slot, valid, n_slots, cap = seen["dispatch_cuda"]
    g_, t_, d_ = v.shape
    k = slot.shape[-1]
    got = dispatch_cuda(v, wd, slot, valid, n_slots, cap)
    ref = dispatch_ref(v, wd, slot, valid, n_slots, cap)
    err = compare("moe_dispatch", got[1:] + got[:1], ref[1:] + ref[:1], 4,
                  0.0)
    es = v.element_size()
    nb = es * (g_ * t_ * d_ + g_ * n_slots * cap * d_) + \
        4 * (5 * g_ * t_ * k + 2 * g_ * n_slots)
    b_ms, b_by = bound_ms(nb, g_ * t_ * k * d_)
    rows.append(dict(
        name="moe_dispatch", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_dispatch.cu",
        replaces="src/repro/kernels/moe_dispatch/moe_dispatch.py:38",
        launches=launches["moe_dispatch"], max_abs_err=err,
        ms=graph_ms(torch, lambda: dispatch_cuda(v, wd, slot, valid,
                                                  n_slots, cap)),
        plain_ms=graph_ms(torch, lambda: dispatch_ref(v, wd, slot, valid,
                                                      n_slots, cap)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    shapes["moe_dispatch"] = {"v": list(v.shape), "k": k, "slots": n_slots,
                              "cap": cap, "tol": 0.0}

    # combine: exact (the k terms added in j order in f32, rounded once, in
    # both).  Library yardstick: one embedding_bag call (weighted sum of
    # the gathered buffer rows), timed here and used nowhere in the port.
    buf, wc, slot, rank, keep = seen["combine_cuda"]
    g_, s_, c_, d_ = buf.shape
    t_, k = slot.shape[1:]
    y = combine_cuda(buf, wc, slot, rank, keep)
    ry = combine_ref(buf, wc, slot, rank, keep)
    err = compare("moe_combine", (y,), (ry,), 0, 0.0)
    groups = torch.arange(g_, device=buf.device)[:, None, None]
    bag_idx = ((groups * s_ + slot.long()) * c_ + rank.long()).reshape(-1, k)
    bag_w = (wc * keep).reshape(-1, k).to(buf.dtype)
    table = buf.reshape(-1, d_)
    # the function reads only the kept rows of the buffer (at most k per
    # token), the four routing words of every assignment, and writes y
    es = buf.element_size()
    n_kept = int((keep != 0).sum().item())
    nb = es * (n_kept * d_ + g_ * t_ * d_) + 4 * 4 * g_ * t_ * k
    b_ms, b_by = bound_ms(nb, 2 * n_kept * d_)
    rows.append(dict(
        name="moe_combine", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_dispatch.cu",
        replaces="src/repro/kernels/moe_dispatch/moe_dispatch.py:78",
        launches=launches["moe_combine"], max_abs_err=err,
        ms=graph_ms(torch, lambda: combine_cuda(buf, wc, slot, rank, keep)),
        plain_ms=graph_ms(torch, lambda: combine_ref(buf, wc, slot, rank,
                                                     keep)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=graph_ms(torch, lambda: F.embedding_bag(
            bag_idx, table, per_sample_weights=bag_w, mode="sum"))))
    shapes["moe_combine"] = {"buf": list(buf.shape), "tokens": g_ * t_,
                             "k": k, "kept": n_kept, "tol": 0.0}
    return rows, shapes


def log_kernel_rows(rows, shapes) -> None:
    """One line a kernel row; ``shapes`` by row name, or by kernel name for
    a row named ``kernel@path``."""
    for r in rows:
        shape = shapes.get(r["name"]) or shapes[r["name"].split("@")[0]]
        log(f"[kernel] {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.4f} "
            f"us by {r['bound_by']}), integer outputs equal, max |err| "
            f"{r['max_abs_err']}, shapes and tolerance {shape}; launches on "
            f"its path {r['launches']}")


def rwkv6_chunked_flops(b, h, t, n):
    """The tensor-core products of RWKV6's chunked form, per token and
    head, each f32 operand in two bf16 pieces (three products where both
    operands are f32, two where one is v): its row of y_state, (r.Gpre) S
    (3 x 2N^2), and of the state update, (k.Gpost)^T v (2 x 2N^2); per
    chunk, A_ij = q k^T for the pairs of distinct sub-chunks (3 x 2N a
    (t, s) pair) and A V over the sub-chunk blocks on or below the
    diagonal (2 x 2N a pair).  The diagonal blocks' A and the decays run
    on the CUDA cores beside the products and are left out."""
    from repro_torch.kernels.rwkv6_scan.rwkv6_scan import CHUNK, SUB
    ns = CHUNK // SUB
    chunks = t / CHUNK
    pairs_qk = SUB * SUB * ns * (ns - 1) // 2 * chunks
    pairs_av = SUB * SUB * ns * (ns + 1) // 2 * chunks
    return b * h * (10 * n * n * t + 6 * n * pairs_qk + 4 * n * pairs_av)


def mamba2_chunked_flops(b, h, t, p, n):
    """The tensor-core products of Mamba2's chunked form: per token and
    head, its row of the chunk's state, x.w B (2PN), and C h_in^T (2PN);
    per pair of a token and one at or before it in its chunk, and head,
    (C B^T . L) x (2P); each with its f32 operand in two bf16 pieces; per
    pair, C B^T (2N) once for all heads.  The f32 element-wise work (about
    5P a token and head, one exp a pair and head) runs on the CUDA cores
    beside the products and takes less time than they do, so it is left
    out."""
    from repro_torch.kernels.mamba2_ssd.mamba2_ssd import CHUNK
    full, rest = divmod(t, CHUNK)
    pairs = full * CHUNK * (CHUNK + 1) // 2 + rest * (rest + 1) // 2
    return b * h * (2 * 4 * p * n * t + 2 * 2 * p * pairs) + \
        b * 2 * n * pairs


def scan_rwkv6(torch, args):
    """The RWKV6 scan on one captured call's inputs: (kernel call, plain
    call, bytes moved, (operations, their peak rate), shapes).  bf16 runs
    the chunked form on the tensor cores, so its operations are the chunked
    form's products at the bf16 rate; f32 runs the exact recurrence on the
    CUDA cores."""
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref
    from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_cuda
    r, k, v, w, u, s0 = args
    b, h, t, n = r.shape
    # r, k, v, w read once and y written once; u; s0 (if any) and sT
    n_states = 1 if s0 is None else 2
    nbytes = r.element_size() * 5 * b * h * t * n + \
        4 * (h * n + n_states * b * h * n * n)
    if r.dtype == torch.bfloat16:
        ops = (rwkv6_chunked_flops(b, h, t, n), BF16_FLOP_PER_S)
    else:
        # per token and head: y = r.S (2N^2), r*u*k summed (3N), + bonus*v
        # (2N), S = w*S + k*v (3N^2)
        ops = (b * h * t * (5 * n * n + 5 * n), F32_FLOP_PER_S)
    return (lambda: rwkv6_cuda(*args)), (lambda: rwkv6_ref(*args)), \
        nbytes, ops, \
        {"r,k,v,w": [b, h, t, n], "dtype": str(r.dtype), "s0": s0 is not None}


def scan_mamba2(torch, args):
    """The Mamba2 scan on one captured call's inputs: (kernel call, plain
    call, bytes moved, (operations, their peak rate), shapes).  bf16 runs
    the chunked form on the tensor cores, so its operations are the chunked
    form's products at the bf16 rate; f32 runs the exact recurrence on the
    CUDA cores."""
    from repro_torch.kernels.mamba2_ssd.mamba2_ssd import mamba2_cuda
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_ref
    x, dt, a, bm, c, d, h0 = args
    b, h, t, p = x.shape
    n = bm.shape[-1]
    es = x.element_size()
    n_states = 1 if h0 is None else 2
    # x read once and y written once; dt; a, d; B and C (shared by the
    # heads); h0 (if any) and hT
    nbytes = es * (2 * b * h * t * p + 2 * b * t * n) + \
        4 * (b * h * t + 2 * h + n_states * b * h * p * n)
    if x.dtype == torch.bfloat16:
        ops = (mamba2_chunked_flops(b, h, t, p, n), BF16_FLOP_PER_S)
    else:
        # per token and head: exp(dt a) (2), dt*x (P), h = h*dec + xd*B
        # (3PN), y = h.C (2PN), + D x (2P)
        ops = (b * h * t * (5 * p * n + 3 * p + 2), F32_FLOP_PER_S)
    return (lambda: mamba2_cuda(*args)), (lambda: mamba2_ref(*args)), \
        nbytes, ops, {"x": [b, h, t, p], "B,C": [b, t, n],
                        "dtype": str(x.dtype), "h0": h0 is not None}


# kernel name (= its source csrc/<name>.cu) -> (inputs to timed calls, its
# wrapper's name in the dispatcher module, the TPU kernel it replaces)
SCANS = {"rwkv6_scan": (scan_rwkv6, "rwkv6_cuda",
                        "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:20"),
         "mamba2_ssd": (scan_mamba2, "mamba2_cuda",
                        "src/repro/kernels/mamba2_ssd/mamba2_ssd.py:17")}


# the device kernels each wrapper call of a scan launches once (the bf16
# route of the model)
SCAN_KERNELS = {"rwkv6_scan": ("rwkv6_scan_chunk_kernel",),
                "mamba2_ssd": ("mamba2_ssd_state_kernel",
                               "mamba2_ssd_pass_kernel",
                               "mamba2_ssd_scan_kernel")}


def check_scan(torch, name, args, launches, tag):
    """A scan kernel against its plain version on the captured inputs,
    both timed; returns the kernels JSON row.  Tolerance: y within one ulp
    of its dtype (2^-7 relative in bf16: the kernel sums in another order,
    so a value may round to the neighbouring ulp) plus 1e-4 of y's scale;
    the final f32 state within 1e-4 of its scale."""
    scan, _, replaces = SCANS[name]
    kern, plain, nbytes, ops, shapes = scan(torch, args)
    y, st = kern()
    ry, rst = plain()
    ulp = 2.0 ** -7 if y.dtype == torch.bfloat16 else 1e-4
    dy = (y.float() - ry.float()).abs()
    y_scale = ry.float().abs().max().item()
    s_err = (st - rst).abs().max().item()
    s_scale = rst.abs().max().item()
    over = dy > ulp * ry.float().abs() + 1e-4 * y_scale
    if over.any() or s_err > 1e-4 * s_scale:
        raise AssertionError(f"{name}: y max |err| {dy.max().item()} "
                             f"({int(over.sum())} over the tolerance), "
                             f"state max |err| {s_err} of {s_scale}")
    b_ms, b_by = bound_ms(nbytes, *ops)
    row = dict(name=name, route="cuda",
               source=f"src/repro_torch/kernels/csrc/{name}.cu",
               replaces=replaces, launches=launches,
               max_abs_err=dy.max().item(),
               ms=graph_ms(torch, kern, reps=10),
               plain_ms=graph_ms(torch, plain, reps=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[{tag}] kernel {name}: {row['ms'] * 1e3:.2f} us (plain "
        f"{row['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us by "
        f"{b_by}), y max |err| {row['max_abs_err']} (|y| <= {y_scale}), "
        f"state max |err| {s_err} (|s| <= {s_scale}); tolerance: y within "
        f"{ulp:g}*|ref| + 1e-4*max|ref|, state within 1e-4*max|ref| "
        f"(sums in another order); shapes {shapes}")
    return row


def ssm_phase(torch, dev, ph, fails) -> tuple:
    """One recurrent family at full width: the forward (its main path),
    the scan kernel against its plain version, forward == decode, serving
    and engine == static.  Returns the scan kernel's JSON row and the
    forward's launch counts; a check that does not hold is appended to
    ``fails`` (so that one run reports every phase) and the caller
    fails."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.mamba2_ssd import ops as mops
    from repro_torch.kernels.rwkv6_scan import ops as rops
    from repro_torch.models import lm
    from repro_torch.runtime.serve import BatchedServer

    tag, name = ph["tag"], ph["kernel"]
    cfg = get_arch(ph["arch"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = lm.init(cfg, gen, dtype=torch.bfloat16, device=dev)
    n_params = sum(p.numel() for p in _leaves(params))
    counts = lm.type_counts(cfg)
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers {counts}, d_model "
        f"{cfg.d_model}, {cfg.n_heads} attention heads, ssm {cfg.ssm}, "
        f"vocab {cfg.vocab}, {n_params} params (bf16)")
    rng = np.random.default_rng(SEED)

    def tokens(b, s):
        return torch.as_tensor(rng.integers(1, cfg.vocab, (b, s)),
                               dtype=torch.long, device=dev)

    ops_mod = rops if name == "rwkv6_scan" else mops
    with torch.no_grad():
        # warm-up at the main path's shape (allocator growth, GEMM
        # heuristics), so the timed forward is a steady-state one
        lm.forward(params, {"tokens": tokens(ph["batch"], FWD_LEN)}, cfg)
        # the main path; the scan's inputs are fresh tensors in every
        # layer and never written again, so capturing keeps references
        toks = tokens(ph["batch"], FWD_LEN)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (logits, _), seen = capture_kernel_inputs(
            torch, lambda: lm.forward(params, {"tokens": toks}, cfg),
            [(ops_mod, SCANS[name][1])], clone=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(LAUNCHES)
        want = counts[ph["block"]]
        if launches[name] != want:
            raise AssertionError(f"{tag}: {launches[name]} {name} launches "
                                 f"in the forward, expected {want}")
        # one flash_fwd launch per occurrence of the shared attention block
        if launches["flash_fwd"] != counts.get("shared_attn", 0):
            raise AssertionError(f"{tag}: {launches['flash_fwd']} flash_fwd "
                                 f"launches in the forward, expected "
                                 f"{counts.get('shared_attn', 0)}")
        if tuple(logits.shape) != (ph["batch"], FWD_LEN, cfg.vocab) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{tag}: bad forward logits")
        n_tok = ph["batch"] * FWD_LEN
        log(f"[{tag}] forward {list(toks.shape)}: {wall:.4f} s, "
            f"{n_tok / wall:.1f} tok/s, launches {launches}")
        mfu_line(tag, cfg, "prefill", ph["batch"], FWD_LEN, wall)
        dry_line(torch, tag, cfg, "prefill", ph["batch"], FWD_LEN, peak)
        del logits
        # the scan's launches on the device: the kernel nodes of a CUDA
        # graph of the same forward, one launch of each kernel a layer
        nodes = graph_kernel_counts(
            torch, lambda: lm.forward(params, {"tokens": toks}, cfg),
            SCAN_KERNELS[name])
        log(f"[{tag}] {name} kernel nodes in a CUDA graph of the forward: "
            f"{nodes} (one a layer: {want})")
        for kern, n_k in nodes.items():
            if n_k != want:
                fails.append(f"{tag}: {n_k} {kern} kernel nodes in a graph "
                             f"of the forward, expected {want}")

        # the same forward again under a CUDA-only trace: device time by
        # kernel, and the busy share of the untraced forward's wall
        def lost(table):
            return sum(want - sum(v[0] for k, v in table.items()
                                  if f"{name}_" in k and kern in k)
                       for kern in SCAN_KERNELS[name])

        wall_t, busy_us, by_name, short = device_trace(
            torch, lambda: lm.forward(params, {"tokens": toks}, cfg),
            lost=lost, tag=tag)
        busy = busy_us / 1e6 / wall
        log(f"[{tag}] forward again under a CUDA-only trace (traced wall "
            f"{wall_t:.4f} s): device busy {busy_us:.0f} us; over the "
            f"untraced forward's wall {wall:.4f} s: busy {busy:.4f}, idle "
            f"{1 - busy:.4f}{partial(short)}")
        log_trace(tag, by_name, 6)
        # the scan's kernels (every one named <name>_*) summed: one launch
        # of each per recurrent layer
        mine = {k: v for k, v in by_name.items() if f"{name}_" in k}
        log(f"[{tag}] {name} in the trace: {len(mine)} kernels, "
            f"{sum(v[0] for v in mine.values())} launches, "
            f"{sum(v[1] for v in mine.values()):.1f} us{partial(short)}")
        row = check_scan(torch, name, seen[SCANS[name][1]], launches[name],
                         tag)
        del seen

        toks = tokens(*EQUIV_FWD)
        forward_decode_check(torch, cfg, params, toks, tag, ph["atol"],
                             "scan", fails)
        block_decode_check(torch, cfg, params, toks, tag, fails)

    # serving through the engine, and engine == static
    max_len = max(SSM_PROMPT_LENS) + SSM_NEW + 16
    srv = BatchedServer(cfg, params, max_len=max_len, slots=4,
                        prefill_chunk=16, decode_chunk=4,
                        compact_decode=False, device=dev)
    del params
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in SSM_PROMPT_LENS]
    # warm-up: the tick's graph is captured on the engine's first tick
    srv.generate([p[:16] for p in prompts], 4)
    replays0 = srv.engine()._tick.graphed.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = srv.generate(prompts, SSM_NEW)
    wall = time.perf_counter() - t0
    if out.shape != (len(prompts), SSM_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"{tag}: bad serve output {out.shape}")
    log(f"[{tag}] serve {len(prompts)} requests, prompts "
        f"{list(SSM_PROMPT_LENS)}, {SSM_NEW} new each: {wall:.4f} s, "
        f"{out.size / wall:.1f} generated tok/s, {srv.engine().tick_no} "
        f"ticks (warm-up included), "
        f"{srv.engine()._tick.graphed.replays - replays0} replays of the "
        f"tick's graph")
    batch = rng.integers(1, cfg.vocab, SSM_STATIC).astype(np.int32)
    t0 = time.perf_counter()
    ref = srv.generate_static(batch, SSM_NEW)
    t_static = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = srv.generate(batch, SSM_NEW)
    t_engine = time.perf_counter() - t0
    if not np.array_equal(got, ref):
        bad = np.argwhere(got != ref)[:5].tolist()
        fails.append(f"{tag}: ServeEngine != generate_static at {bad}")
    log(f"[{tag}] ServeEngine (graphed tick) vs generate_static on "
        f"{list(SSM_STATIC)} + {SSM_NEW}: equal {np.array_equal(got, ref)}, "
        f"engine "
        f"{t_engine:.4f} s, static {t_static:.4f} s")
    return row, launches


# [rwkv6 train] and [zamba2 train]: the recurrent families trained through
# the scans' backward kernels, after their forward phases.  Each runs
# train_compare on a cut of its own (``compare``: the layer pattern, at
# full width, on 2 x ``compare_seq`` tokens; the plain step's per-token
# autograd keeps every state), then TrainLoop at ``layers`` (rwkv6 not cut;
# zamba2 cut to 30 of 81 layers, 25 mamba and 5 shared_attn, where the dry
# run admits 44 at this batch: the headroom covers the allocator's rounding
# and the run's other live bytes), a warm-up step whose last scan backward
# call is captured, and ``steps`` steps of the main path.  zamba2's compare
# cut is one mamba and one shared_attn block (so flash's backward at hd 112
# is held too): the random-weight model amplifies a one-ulp change of a
# scan's bf16 output layer by layer (scripts/scan_jitter_check.py: 0.6 %
# of a gradient's norm through 1 mamba layer, 11 % through 5), so a deeper
# cut measures that amplification rather than the kernels.
SSM_TRAIN = (
    dict(tag="rwkv6 train", arch="rwkv6-1.6b", layers=None, batch=2,
         seq=1024, mb=2, steps=3, compare=("rwkv", "rwkv"), compare_seq=128,
         kernel="rwkv6_scan", block="rwkv"),
    dict(tag="zamba2 train", arch="zamba2-7b", layers=30, batch=2,
         seq=1024, mb=2, steps=3, compare=("mamba", "shared_attn"),
         compare_seq=128, kernel="mamba2_ssd", block="mamba"),
)


def scan_bwd_rwkv6(torch, args):
    """The RWKV6 backward on one captured call's inputs: (kernel call,
    plain call, bytes moved, (operations, their peak rate), shapes).  In
    bf16 the function is bounded as the bf16 forward is, by the chunked
    form on the tensor cores: each of its products has two of the same
    size in the backward (one for each operand's gradient).  In f32 its
    work per token and head is the exact recurrence's on the CUDA cores:
    the states once (S = w S + k v^T, 3N^2) and the walk back (dr, dk, dw,
    dv sums and the G update, 11N^2)."""
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_bwd_ref
    from repro_torch.kernels.rwkv6_scan.rwkv6_scan import rwkv6_bwd_cuda
    r, k, v, w, u, dy, s0, ds_t = args
    b, h, t, n = r.shape
    # r, k, v, w, dy read once, dr, dk, dv, dw written once; u and du;
    # s0/ds0 and dsT where given
    n_states = sum(x is not None for x in (s0, s0, ds_t))
    nbytes = r.element_size() * 9 * b * h * t * n + \
        4 * (2 * h * n + n_states * b * h * n * n)
    if r.dtype == torch.bfloat16:
        ops = (2 * rwkv6_chunked_flops(b, h, t, n), BF16_FLOP_PER_S)
    else:
        ops = (b * h * t * 14 * n * n, F32_FLOP_PER_S)
    return (lambda: rwkv6_bwd_cuda(*args)), (lambda: rwkv6_bwd_ref(*args)), \
        nbytes, ops, {"r,k,v,w,dy": [b, h, t, n], "dtype": str(r.dtype),
                      "s0": s0 is not None, "dsT": ds_t is not None}


def scan_bwd_mamba2(torch, args):
    """The Mamba2 backward on one captured call's inputs, as
    ``scan_bwd_rwkv6``: in bf16 twice the chunked form's products at the
    bf16 rate; in f32, per token and head, the states once (3PN) and the
    walk back (G, the dx, ddt, dB, dC sums, 11PN) on the CUDA cores."""
    from repro_torch.kernels.mamba2_ssd.mamba2_ssd import mamba2_bwd_cuda
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_bwd_ref
    x, dt, a, bm, c, d, dy, h0, dh_t = args
    b, h, t, p = x.shape
    n = bm.shape[-1]
    es = x.element_size()
    n_states = sum(z is not None for z in (h0, h0, dh_t))
    # x, dy read and dx written; dt read and ddt written; B, C read and
    # dB, dC written; a, d, da, dd; h0/dh0 and dhT where given
    nbytes = es * (3 * b * h * t * p + 4 * b * t * n) + \
        4 * (2 * b * h * t + 4 * h + n_states * b * h * p * n)
    if x.dtype == torch.bfloat16:
        ops = (2 * mamba2_chunked_flops(b, h, t, p, n), BF16_FLOP_PER_S)
    else:
        ops = (b * h * t * 14 * p * n, F32_FLOP_PER_S)
    return (lambda: mamba2_bwd_cuda(*args)), \
        (lambda: mamba2_bwd_ref(*args)), nbytes, ops, \
        {"x,dy": [b, h, t, p], "B,C": [b, t, n], "dtype": str(x.dtype),
         "h0": h0 is not None, "dhT": dh_t is not None}


# kernel -> (timed calls, its wrapper's name, the TPU kernel whose
# function's gradient it computes: the reference differentiates its jnp
# scan)
SCAN_BWDS = {"rwkv6_scan_bwd": (scan_bwd_rwkv6, "rwkv6_bwd_cuda",
                                "src/repro/kernels/rwkv6_scan/"
                                "rwkv6_scan.py:59"),
             "mamba2_ssd_bwd": (scan_bwd_mamba2, "mamba2_bwd_cuda",
                                "src/repro/kernels/mamba2_ssd/"
                                "mamba2_ssd.py:52")}


def check_scan_bwd(torch, name, args, launches, tag):
    """A scan backward kernel against its plain backward on one layer's
    captured inputs and dy, both timed; returns the kernels JSON row.
    Tolerance, each gradient element-wise: one ulp of its dtype (2^-7
    relative in bf16, 1e-4 in f32: the kernel sums in another order, so a
    bf16 value may round to the neighbouring ulp) plus 1e-4 of the
    gradient's scale (sums over up to T tokens that cancel)."""
    scan, _, replaces = SCAN_BWDS[name]
    kern, plain, nbytes, ops, shapes = scan(torch, args)
    got, want = kern(), plain()
    worst, report = 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None:
            continue
        ulp = 2.0 ** -7 if g.dtype == torch.bfloat16 else 1e-4
        err = (g.float() - w.float()).abs()
        scale = w.float().abs().max().item()
        over = int((err > ulp * w.float().abs() + 1e-4 * scale).sum())
        worst = max(worst, err.max().item())
        report.append(f"{i}: {err.max().item():.3g} of {scale:.3g}"
                      f"{f' ({over} over)' if over else ''}")
        if over or g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: gradient {i} differs from the "
                                 f"plain backward: {report[-1]}")
    b_ms, b_by = bound_ms(nbytes, *ops)
    row = dict(name=name, route="cuda",
               source=f"src/repro_torch/kernels/csrc/{name}.cu",
               replaces=replaces, launches=launches, max_abs_err=worst,
               ms=graph_ms(torch, kern, reps=10),
               plain_ms=graph_ms(torch, plain, reps=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[{tag}] kernel {name}: {row['ms'] * 1e3:.2f} us (plain "
        f"{row['plain_ms'] * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us by "
        f"{b_by}); max |err| per gradient (of its max |ref|) "
        f"{'; '.join(report)}; tolerance: within one ulp of its dtype "
        f"(2^-7 bf16, 1e-4 f32) of |ref| + 1e-4*max|ref|; shapes {shapes}")
    return row


def ssm_train(torch, dev, tr, fails) -> list:
    """One recurrent family trained on the card (``SSM_TRAIN``); returns
    its scan backward kernel's JSON row."""
    import re
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.mamba2_ssd import ops as mops
    from repro_torch.kernels.rwkv6_scan import ops as rops
    from repro_torch.models import lm
    from repro_torch.runtime.loop import LoopConfig, TrainLoop
    from repro_torch.runtime.train import TrainHyper
    tag, n_mb = tr["tag"], tr["mb"]
    full = get_arch(tr["arch"])
    hyper = TrainHyper()

    def loop_for(cfg, batch, seq, remat="none"):
        stream = TokenStream(vocab=cfg.vocab, seq_len=seq,
                             global_batch=batch, seed=SEED)
        loop = TrainLoop(cfg, stream,
                         dataclasses.replace(hyper, remat=remat),
                         LoopConfig(microbatches=n_mb, device=str(dev)),
                         seed=SEED)
        log(f"[{tag}] {cfg.name} at {cfg.num_layers} of {full.num_layers} "
            f"layers {lm.type_counts(cfg)}, d_model {cfg.d_model}, ssm "
            f"{cfg.ssm}, vocab {cfg.vocab}, "
            f"{sum(p.numel() for p in _leaves(loop.state['params']))} f32 "
            f"params; global batch {batch} x {seq} in {n_mb} microbatches, "
            f"remat {remat}")
        return loop, TokenStream(vocab=cfg.vocab, seq_len=seq,
                                 global_batch=batch, seed=SEED)

    ccfg = dataclasses.replace(full, num_layers=len(tr["compare"]),
                               layer_pattern=tr["compare"])
    loop, stream = loop_for(ccfg, tr["batch"], tr["compare_seq"])
    train_compare(torch, ccfg, hyper, loop.state,
                  torch.as_tensor(stream.next()["tokens"], device=dev),
                  loop._plan_args(), fails, n_mb=n_mb, tag=tag)
    del loop
    _free(torch)

    cfg = cut(full, tr["layers"])
    loop, _ = loop_for(cfg, tr["batch"], tr["seq"])
    ops_mod = rops if tr["kernel"] == "rwkv6_scan" else mops
    bwd = f"{tr['kernel']}_bwd"
    # the warm-up step; the scan backward's last call's inputs kept, and
    # the parameters it made, for the remat step below
    _, seen = capture_kernel_inputs(torch, lambda: loop.run(1),
                                    [(ops_mod, SCAN_BWDS[bwd][1])])
    after_first = [p.clone() for p in _leaves(loop.state["params"])]
    counts = lm.type_counts(cfg)
    rec, attn = counts[tr["block"]] * n_mb, \
        counts.get("shared_attn", 0) * n_mb

    def per_step(remat):
        """A step's launches: the forward kernels again in the backward's
        recompute under a remat policy."""
        fwd = 1 if remat == "none" else 2
        out = {k: 0 for k in LAUNCHES}
        out.update({tr["kernel"]: fwd * rec, bwd: rec,
                    "flash_fwd": fwd * attn, "flash_bwd": attn})
        return out

    held = held_bytes(after_first)
    wall = train_steps(torch, loop, per_step("none"), tr["steps"], tag,
                       fails, held=held)
    launches = LAUNCHES[bwd]
    # one more step under a CUDA-only trace: a step's device time, and the
    # backward's kernels by name
    wall_t, busy_us, by_name, _ = device_trace(torch, lambda: loop.run(1))
    log(f"[{tag}] one more step under a CUDA-only trace (traced wall "
        f"{wall_t:.4f} s): device busy {busy_us:.0f} us; over the untraced "
        f"steps' mean wall {wall:.4f} s: busy {busy_us / 1e6 / wall:.4f}")
    log_trace(tag, by_name, 10)
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        kernel = re.search(r"(\w+_kernel(?:<[^>]*>)?)\(", name)
        if kernel and kernel.group(1).startswith(f"{bwd}_"):
            log(f"[{tag}] backward kernel {kernel.group(1)}: {n} launches, "
                f"{us:.1f} us, {us / n:.2f} us a launch")
    adds_and_fills(tag, by_name, busy_us, wall)
    del loop
    _free(torch)
    remat_step(torch, tag, cfg, lambda: loop_for(cfg, tr["batch"], tr["seq"],
                                                 "full")[0],
               after_first, held, per_step("full"), fails)
    del after_first
    _free(torch)
    row = check_scan_bwd(torch, bwd, seen[SCAN_BWDS[bwd][1]], launches, tag)
    del seen
    _free(torch)
    return [row]


# the CUDA-only trace of one step (H100 80GB HBM3, 700 W) before each block
# type's layers were taken with one unbind a forward, when each layer's
# select made a zero fill and an add of the whole stack: torch's bf16
# elementwise adds and fills, (ms, launches) (PERF.md, section 6)
BEFORE_UNBIND = {"rwkv6 train": ((125.5, 2696), (39.4, 1202)),
                     "zamba2 train": ((192.7, 1248), (61.1, 902))}


def adds_and_fills(tag, by_name, busy_us, wall) -> None:
    """torch's bf16 elementwise add and fill kernels in a step's trace,
    beside BEFORE_UNBIND's, with the step's device time and wall."""
    got = {"add": [0, 0.0], "fill": [0, 0.0]}
    for name, (n, us) in by_name.items():
        for kind, mark in (("add", "CUDAFunctor_add<c10::BFloat16>"),
                           ("fill", "FillFunctor<c10::BFloat16>")):
            if mark in name:
                got[kind][0] += n
                got[kind][1] += us
    (a_ms, a_n), (f_ms, f_n) = BEFORE_UNBIND[tag]
    log(f"[{tag}] a step's bf16 adds {got['add'][1] / 1e3:.1f} ms "
        f"({got['add'][0]} launches; with a select per layer {a_ms} ms, "
        f"{a_n} launches), bf16 fills {got['fill'][1] / 1e3:.1f} ms "
        f"({got['fill'][0]} launches; with a select per layer {f_ms} ms, "
        f"{f_n} launches); the step's device time {busy_us / 1e3:.1f} ms "
        f"and mean wall {wall:.4f} s; {card()}")


def remat_step(torch, tag, cfg, make_loop, after_first, held, per_step,
               fails) -> None:
    """A ``TrainLoop`` under ``remat="full"`` from the initial state of the
    loop just run (the same seed, stream and plan): its first step must
    give that loop's first step's parameters ``after_first`` (``held``
    bytes on the card) bit for bit; its second step is the main path's
    (launch counts set to 0 just before and read just after:
    ``per_step``, the forward kernels twice), with its wall and its peak
    device memory (less ``held``) beside the dry run's prediction under
    ``"full"``."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    loop = make_loop()
    loop.run(1)
    same = all(torch.equal(a, b) for a, b in zip(
        after_first, _leaves(loop.state["params"])))
    log(f"[{tag}] remat full: the first step's parameters equal the "
        f"remat-none loop's first step's bit for bit: {same}")
    if not same:
        fails.append(f"{tag}: the remat-full step differs from the "
                     f"remat-none step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    h = loop.run(1)[-1]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    got = {k: LAUNCHES[k] for k in per_step}
    n_tok = loop.stream.global_batch * loop.stream.seq_len
    log(f"[{tag}] remat full, step {h['step']}: loss {h['loss']:.6f}; "
        f"{wall:.4f} s, {n_tok / wall:.1f} training tok/s; launches "
        f"{_nonzero(got)} (the code predicts {_nonzero(per_step)}); peak "
        f"device memory {peak / 2 ** 30:.2f} GiB (less "
        f"{held / 2 ** 30:.2f} GiB kept for the check)")
    if got != per_step or not np.isfinite(h["loss"]):
        fails.append(f"{tag}: the remat-full step launched {got}, the code "
                     f"predicts {per_step}")
    gb, seq, mb = loop.stream.global_batch, loop.stream.seq_len, \
        loop.lc.microbatches
    mfu_line(f"{tag} remat full", cfg, "train", gb, seq, wall, mb, "full")
    dry_line(torch, f"{tag} remat full", cfg, "train", gb, seq, peak, mb,
             "full")
    del loop


def forward_decode_check(torch, cfg, params, toks, tag, atol, kernel,
                         fails) -> None:
    """Forward == step-by-step decode on ``toks``.  With random weights the
    full bf16 stack amplifies rounding layer by layer, so the whole model's
    argmax is held only where the decode's top-2 margin exceeds twice the
    larger of the reference's tolerance ``atol`` and the logit change that
    the ``kernel``'s summation order alone causes (the forward through its
    plain version against the forward through the kernel); each block type
    on its own, which is well conditioned, is held within BLOCK_TOL
    (``block_decode_check``)."""
    from repro_torch.models import lm
    b, s = toks.shape
    fwd, _ = lm.forward(params, {"tokens": toks}, cfg)
    again, _ = lm.forward(params, {"tokens": toks}, cfg)
    plain, _ = lm.forward(params, {"tokens": toks}, cfg, impl="torch")
    noise = (plain - fwd).abs().max().item()
    state = lm.init_cache(cfg, b, s, device=toks.device)
    t0 = time.perf_counter()
    dec = []
    for i in range(s):
        lg, state = lm.decode_step(params, state, toks[:, i:i + 1], cfg)
        dec.append(lg)
    dec = torch.stack(dec, 1)
    t_dec = time.perf_counter() - t0
    del state
    top2 = dec.topk(2, dim=-1).values
    margin_tol = 2 * max(atol, noise)
    sure = (top2[..., 0] - top2[..., 1]) > margin_tol
    differ = dec.argmax(-1) != fwd.argmax(-1)
    diff = (dec - fwd).abs().max().item()
    log(f"[{tag}] forward vs decode on {list(toks.shape)}: max |logit "
        f"diff| {diff} (max |logit| {fwd.abs().max().item()}); the "
        f"forward through the plain {kernel} differs from the kernel's by "
        f"{noise}; argmax equal at {int((~differ).sum())} of "
        f"{differ.numel()} positions, {int((sure & differ).sum())} "
        f"differ of the {int(sure.sum())} whose decode top-2 margin "
        f"exceeds {margin_tol} (twice the larger of that and "
        f"{atol}); a second kernel forward equal bit for "
        f"bit: {torch.equal(again, fwd)}; decode {t_dec:.4f} s "
        f"({s} steps)")
    if (sure & differ).any() or not torch.isfinite(dec).all() or \
            not torch.equal(again, fwd):
        fails.append(f"{tag}: step-by-step decode does not reproduce "
                     f"the forward")


def block_decode_check(torch, cfg, params, toks, tag, fails) -> None:
    """For each block type, its last layer on the hidden states the forward
    feeds it: the full-sequence apply (through the kernels) against the
    block's step-by-step decode from an empty cache, every output within
    BLOCK_TOL of the output's scale plus BLOCK_TOL relative (bf16 rounds at
    other points in the two paths).  An ``moe`` layer routes with an
    identity plan at a capacity factor of 8, so that neither path drops an
    assignment (as tests/test_serve_consistency.py raises it): the forward
    routes all its tokens as one group, each decode step its batch."""
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.blocks import BLOCKS
    inputs, applies = {}, {t: BLOCKS[t]["apply"] for t in lm.type_counts(cfg)}

    def recorder(t, fn):
        def apply(p, x, ctx):
            inputs[t] = (p, x)                 # the last occurrence stays
            return fn(p, x, ctx)
        return apply

    for t, fn in applies.items():
        BLOCKS[t]["apply"] = recorder(t, fn)
    try:
        lm.forward(params, {"tokens": toks}, cfg)
    finally:
        for t, fn in applies.items():
            BLOCKS[t]["apply"] = fn
    b, s = toks.shape
    dev = toks.device
    pos = torch.arange(s, device=dev)
    moe_ctx = {}
    if cfg.moe is not None:
        wide = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
        plan = moe_lib.identity_plan(wide, 1, device=dev)
        moe_ctx = {"cfg": wide, "moe_groups": "batch", "moe_metrics": [],
                   "plan_slots": plan.slots[0], "plan_cum": plan.cum[0]}
    out = []
    for t, (p, x) in inputs.items():
        extra = moe_ctx if t == "moe" else {}
        ref = applies[t](p, x, {"cfg": cfg, "impl": "auto",
                                "positions": pos[None].expand(b, s),
                                "token_offset": 0, **extra})
        cache = BLOCKS[t]["cache"](cfg, b, s, None, dev)
        got = torch.cat([BLOCKS[t]["decode"](
            p, x[:, i:i + 1], cache, {"cfg": cfg, "pos": pos[i].expand(b),
                                      "token_offset": pos[i:i + 1], **extra})
            for i in range(s)], dim=1)
        err = (got.float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        ok = bool((err <= BLOCK_TOL * (scale + ref.float().abs())).all())
        out.append(f"{t} max |diff| {err.max().item()} of {scale}")
        if not ok:
            fails.append(f"{tag}: block {t} decode does not reproduce its "
                         f"forward")
    log(f"[{tag}] each block type's last layer, forward vs step-by-step "
        f"decode on the forward's hidden states {list(toks.shape)}: "
        f"{'; '.join(out)} (tolerance {BLOCK_TOL} of the scale + "
        f"{BLOCK_TOL} relative)")


def _free(torch) -> None:
    """Return the last phase's device memory before the next model."""
    gc.collect()
    torch.cuda.empty_cache()


# traces of one repeatable call taken at most, when one lost records
TRACE_TRIES = 3


def device_trace(torch, fn, gaps=None, lost=None, tag="trace"):
    """Run ``fn()`` under a CUDA-only ``torch.profiler`` trace (no CPU
    activity, so the host's op dispatch is not traced).  Returns the traced
    call's wall seconds, the device time summed over the trace in µs (one
    stream, so no overlap), ``{kernel name: [launches, µs]}`` and the
    launch records the kept trace misses by ``lost`` (0 without it).  A list
    ``gaps`` receives the device's idle gaps in µs, between the first
    traced activity and the last.  A trace gives times only: every launch
    count the run checks comes from ``kernels.LAUNCHES`` or from the nodes
    of a CUDA graph of the work (``kernels.graphs``), which a capture
    cannot lose.  CUPTI may drop activity records (a one-call trace comes
    back empty now and then: ``scripts/trace_probe.py``), so ``lost``, a
    function of the table giving how many launch records it misses, lets
    a short trace be taken again (``fn`` must be repeatable), up to
    TRACE_TRIES traces; a trace still short is logged under ``tag`` with
    the records it lost, and every reading of its times carries
    ``partial(short)``."""
    from torch.profiler import ProfilerActivity, profile

    def settle():
        # a kernel and a short host pause on each side of the traced work,
        # so that no record of it is lost at the trace's edges
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)

    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            settle()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            settle()
        # the profiler's raw records: building its FunctionEvents from a
        # serve trace's hundreds of thousands of records takes the host
        # tens of seconds
        by_name, spans = {}, []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                n = by_name.setdefault(e.name(), [0, 0.0])
                n[0] += 1
                n[1] += e.duration_ns() / 1e3
                spans.append((e.start_ns() / 1e3, e.end_ns() / 1e3))
        short = lost(by_name) if lost is not None else 0
        if not short:
            break
        log(f"[{tag}] trace {attempt} is short of {short} launch records"
            + ("; tracing again" if attempt < TRACE_TRIES else
               f"; after {TRACE_TRIES} traces its times are partial "
               f"(counts come from LAUNCHES and graph nodes)"))
    if gaps is not None:
        spans.sort()
        end = spans[0][1] if spans else 0
        for a, b in spans[1:]:
            if a > end:
                gaps.append(a - end)
            end = max(end, b)
    busy = sum(v[1] for v in by_name.values())
    if busy <= 0:
        raise AssertionError("the CUDA trace recorded no device time")
    return wall, busy, by_name, short


def partial(short) -> str:
    """The mark of a reading taken from a trace short of ``short`` launch
    records (``device_trace``), empty for a whole trace."""
    return (f" (partial: the trace lost {short} launch records)" if short
            else "")


def graph_kernel_counts(torch, fn, names):
    """How many kernel nodes a CUDA graph of one call of ``fn()`` holds
    whose name contains each of ``names`` (``fn`` has run eagerly before,
    so nothing of a first call lands in the capture): the call's launches
    on the device, which a capture cannot lose.  The graph is dropped."""
    from repro_torch.kernels.graphs import capture_nodes
    nodes, graph = capture_nodes(torch, fn)
    del graph
    kern = [name for kind, name in nodes if kind == "kernel"]
    return {n: sum(n in k for k in kern) for n in names}


def log_trace(tag, by_name, top) -> None:
    """Log the ``top`` kernels of a trace by device time, then every other
    kernel of the port's (they sit in an anonymous namespace)."""
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for i, (name, (n, us)) in enumerate(ranked):
        if i < top or "(anonymous namespace)::" in name:
            log(f"[{tag}]   {us:10.1f} us {n:6d} launches  {name[:90]}")


def serve_kernel_inputs(torch, cfg, params, dev, rng, slots=None):
    """The MoE kernels' inputs at the decode tick's shapes: four eager runs
    of the tick's own decode step over ``slots`` (by default
    len(PROMPT_LENS)) fresh slots, the last call of each kernel kept (the
    graphed tick replays kernels that no wrapper sees)."""
    from repro_torch.engine.serve import SlotPool, build_decode_step
    b = slots or len(PROMPT_LENS)
    pool = SlotPool(cfg, b, 16, dev)
    step = build_decode_step(cfg, dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)

    @torch.no_grad()
    def run():
        for _ in range(4):
            tok = torch.as_tensor(rng.integers(1, cfg.vocab, b), device=dev)
            step(params, None, pool, tok, active)
    return capture_kernel_inputs(torch, run)[1]


def graph_check(torch, cfg, params, dev, rng, tag, fails) -> None:
    """One prefill tick (16 tokens: prompts of 16, 11, 7 and 1 over 8
    slots, 2 of them idle) and one decode tick (4 tokens) through the
    graphed and the eager tick, on two pools in the same state: every
    step's logits, the tokens, the positions and every cache leaf must be
    equal bit for bit.  Then both ticks' host wall per decode tick, in
    turns."""
    from repro_torch.engine.serve import SlotPool, SlotTick
    b = len(PROMPT_LENS)
    pools = [SlotPool(cfg, b, 128, dev) for _ in range(2)]
    ticks = [SlotTick(cfg, dev, graph=g) for g in (True, False)]
    for t in ticks:
        t.record = []
    temps, gens = np.zeros(b, np.float32), [None] * b
    active = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)[:b]
    toks = rng.integers(1, cfg.vocab, (b, 16))
    n_given = np.array([16, 11, 7, 1, 16, 16, 1, 1])[:b]
    outs = [t(p, params, None, toks, n_given, active,
              np.ones(b, bool), temps, gens) for t, p in zip(ticks, pools)]
    same_toks = np.array_equal(outs[0][1], outs[1][1])
    dec = np.zeros((b, 4), np.int64)
    dec[:, 0] = outs[0][1][:, -1]
    outs = [t(p, params, None, dec, np.ones(b, np.int64), active,
              np.zeros(b, bool), temps, gens) for t, p in zip(ticks, pools)]
    same_toks = same_toks and np.array_equal(outs[0][1], outs[1][1])
    same_logits = [torch.equal(a, c) for a, c in zip(*(t.record
                                                        for t in ticks))]
    diff = max((a - c).abs().max().item()
               for a, c in zip(*(t.record for t in ticks)))
    same_state = torch.equal(pools[0].pos, pools[1].pos) and all(
        torch.equal(a, c) for (_, a, _), (_, c, _) in zip(
            pools[0].row_leaves(), pools[1].row_leaves()))
    for t in ticks:
        t.record = None
    walls = {True: [], False: []}
    for _ in range(4):
        for t, p in zip(ticks, pools):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t(p, params, None, dec, np.ones(b, np.int64), active,
              np.zeros(b, bool), temps, gens)
            torch.cuda.synchronize()
            walls[t.graph].append(time.perf_counter() - t0)
    g = ticks[0].graphed
    log(f"[graph] {tag}: a prefill tick of 16 and a decode tick of 4 over "
        f"{b} slots, graphed vs eager tick from the same state: logits "
        f"equal bit for bit at {sum(same_logits)} of {len(same_logits)} "
        f"steps (max |diff| {diff}), tokens equal {same_toks}, positions and "
        f"caches equal {same_state}; {g.replays} replays, per replay the "
        f"launches {_nonzero(g.per_replay)}; host wall of a decode tick of 4 "
        f"(in turns, best of 4): graphed {min(walls[True]):.6f} s, eager "
        f"{min(walls[False]):.6f} s")
    if not (all(same_logits) and same_toks and same_state):
        fails.append(f"{tag}: the graphed tick differs from the eager tick")
    del pools, ticks


def replay_spans(torch, eng, fn) -> tuple:
    """Run ``fn()`` with CUDA events around every replay of ``eng``'s tick
    graph (no profiler, which slows the host).  Returns seconds: the wall,
    the device time inside replays, and the time from one replay's end to
    the next one's start, within a tick and across ticks."""
    graphed = eng._tick.graphed
    real, marks = graphed.graph, []

    class Timed:
        def replay(self):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            real.replay()
            b.record()
            marks.append((eng.tick_no, a, b))

    graphed.graph = Timed()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        graphed.graph = real
    inside = sum(a.elapsed_time(b) for _, a, b in marks) / 1e3
    within = across = 0.0
    for (tick0, _, end), (tick1, start, _) in zip(marks, marks[1:]):
        if tick0 == tick1:
            within += end.elapsed_time(start) / 1e3
        else:
            across += end.elapsed_time(start) / 1e3
    return wall, inside, within, across


def _nonzero(counts) -> dict:
    return {k: v for k, v in counts.items() if v}


def moe_phase(torch, dev, fails) -> tuple:
    """The MoE serving main path, its device trace, the graphed tick
    against the eager one, the MoE kernels against their plain versions,
    and engine == static.  Returns the kernels' JSON rows and the main
    path's launches."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.runtime.serve import BatchedServer

    cfg = moe_cfg()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = lm.init(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[model] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts}+{cfg.moe.spare_slots} "
        f"slots, top-{cfg.moe.top_k}, vocab {cfg.vocab}, {n_params} params")
    max_len = max(PROMPT_LENS) + MAX_NEW + 32
    srv = BatchedServer(cfg, params, max_len=max_len, slots=len(PROMPT_LENS),
                        prefill_chunk=16, decode_chunk=4,
                        compact_decode=False, device=dev)
    del params
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in PROMPT_LENS]

    # warm-up on the same server (first-use costs, the tick's graph
    # capture among them, stay out of the timed run)
    srv.generate([p[:16] for p in prompts], 4)
    graphed = srv.engine()._tick.graphed
    replays0 = graphed.replays

    # the main path
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = srv.generate(prompts, MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    replays = graphed.replays - replays0
    if out.shape != (len(prompts), MAX_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"bad serve output {out.shape}")
    missing = [k for k in ("moe_gating", "moe_dispatch", "moe_combine",
                           "decode_attn") if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    # every launch of the main path is one that a replay of the graph made
    if launches != {k: replays * n for k, n in graphed.per_replay.items()}:
        raise AssertionError(f"main path launches {launches} are not "
                             f"{replays} replays of {graphed.per_replay}")
    gen_toks = out.size
    prompt_toks = sum(PROMPT_LENS)
    eng = srv.engine()
    log(f"[serve] {len(prompts)} requests, prompts {list(PROMPT_LENS)}, "
        f"{MAX_NEW} new each: {wall:.4f} s, {gen_toks / wall:.1f} "
        f"generated tok/s, {(gen_toks + prompt_toks) / wall:.1f} "
        f"processed tok/s, {eng.tick_no} ticks; {replays} replays of the "
        f"tick's graph, each credited {_nonzero(graphed.per_replay)}; "
        f"launches {launches}")

    t_tok = {k: v for k, v in eng.engine.costs.snapshot().items()
             if k.endswith("_per_tok") and ":" not in k}
    log(f"[serve] measured per-token tick EMAs (s): {t_tok}")

    # the main path's work once more under a CUDA-only trace: its device
    # time over the untraced main path's wall gives the busy share; the
    # trace must see the replays' kernels (one gating launch per MoE layer
    # and replay)
    ticks0, replays0 = eng.tick_no, graphed.replays
    gaps = []
    # the replays' gating launches on the device: the gating kernel nodes
    # of the tick's graph, against the capture's host count
    nodes = sum("gating" in k for k in graphed.kernel_nodes())
    if nodes != graphed.per_replay["moe_gating"]:
        fails.append(f"serve: the tick's graph holds {nodes} gating kernel "
                     f"nodes, its capture counted "
                     f"{graphed.per_replay['moe_gating']}")

    def gating_lost(table):
        want = (graphed.replays - replays0) * nodes
        return want - sum(n for name, (n, _) in table.items()
                          if "gating" in name)

    wall_t, busy_us, by_name, short = device_trace(
        torch, lambda: srv.generate(prompts, MAX_NEW), gaps,
        lost=gating_lost, tag="profile")
    busy = busy_us / 1e6 / wall
    traced = sum(n for name, (n, _) in by_name.items() if "gating" in name)
    log(f"[profile] main path's work again under a CUDA-only trace "
        f"({eng.tick_no - ticks0} ticks, {graphed.replays - replays0} "
        f"replays, traced wall {wall_t:.4f} s): device busy {busy_us:.0f} "
        f"us; over the untraced main path's wall {wall:.4f} s: busy "
        f"{busy:.4f}, idle {1 - busy:.4f}{partial(short)}; gating kernels "
        f"in the trace {traced}, {nodes} gating nodes a replay in the "
        f"tick's graph")
    # the device's idle gaps by length: the host's work between ticks
    # (planning, the tick's host copy) shows as gaps of about a millisecond,
    # one a tick; launch gaps inside a replayed step as microseconds
    parts = []
    for lo, hi in ((0, 20), (20, 500), (500, float("inf"))):
        sel = [g for g in gaps if lo <= g < hi]
        parts.append(f"[{lo}, {hi}): {len(sel)} gaps, {sum(sel) / 1e3:.3f} "
                     f"ms, {sum(sel) / 1e6 / wall_t:.4f} of the traced wall")
    log(f"[profile] device idle gaps in the trace, by length in us: "
        f"{'; '.join(parts)}; {eng.tick_no - ticks0} ticks (the trace "
        f"slows the host: its traced wall is longer){partial(short)}")
    # the same work with CUDA events around every replay, untraced: where
    # the wall goes between the graph's replays
    ticks0 = eng.tick_no
    wall_e, inside, within, across = replay_spans(
        torch, eng, lambda: srv.generate(prompts, MAX_NEW))
    log(f"[profile] the same work with events around each replay, "
        f"untraced: wall {wall_e:.4f} s over {eng.tick_no - ticks0} ticks; "
        f"inside replays {inside:.4f} s ({inside / wall_e:.4f} of the wall), "
        f"between replays of one tick {within:.4f} s ({within / wall_e:.4f}),"
        f" between ticks {across:.4f} s ({across / wall_e:.4f})")
    log_trace("profile", by_name, 8)

    graph_check(torch, cfg, srv.params, dev, rng, cfg.name, fails)

    seen = serve_kernel_inputs(torch, cfg, srv.params, dev, rng)
    rows, shapes = check_kernels(torch, seen, launches)
    # gating at E 128, k 8 (qwen3-moe-235b-a22b's routing) over a
    # microbatch of 4096 tokens; no main path runs it yet
    wide = torch.randn((1, 4096, 128), generator=gen, device=dev)
    rows.append(gating_row(torch, wide, 8, 0, "moe_gating@e128"))
    shapes["moe_gating@e128"] = {"logits": list(wide.shape), "k": 8,
                                 "tol": 1e-6}
    log_kernel_rows(rows, shapes)

    # greedy ServeEngine == generate_static on a drop-free batch
    srv4 = BatchedServer(cfg, srv.params, max_len=max_len, slots=4,
                         prefill_chunk=16, decode_chunk=4,
                         compact_decode=False, device=dev)
    batch = rng.integers(1, cfg.vocab, (4, 64)).astype(np.int32)
    t0 = time.perf_counter()
    ref = srv4.generate_static(batch, MAX_NEW)
    t_static = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = srv4.generate(batch, MAX_NEW)
    t_engine = time.perf_counter() - t0
    if not np.array_equal(got, ref):
        bad = np.argwhere(got != ref)[:5].tolist()
        raise AssertionError(f"ServeEngine != generate_static at {bad}")
    log(f"[equiv] ServeEngine (graphed tick) == generate_static on [4, 64] "
        f"+ {MAX_NEW}: engine {t_engine:.4f} s, static {t_static:.4f} s")
    return rows, launches


# [spec], [prefix], [publish]: the serve engine's speculative arms, its
# prefix and result cache and the hot weight publish, on paper-moe-100m at
# full width (the [serve] model, 8 slots, random weights from SEED)
SERVE_SLOTS = len(PROMPT_LENS)
SERVE_MAX_LEN = max(PROMPT_LENS) + MAX_NEW + 32
MOTIF = 8                       # [spec] prompts repeat a motif of 8 tokens
# [prefix]: 16 requests share a 96-token prefix, each with its own suffix
# (4 of each length, so the static oracle runs 4 drop-free batches of 4)
PREFIX_LEN, PREFIX_SUFFIXES, PREFIX_REQS, PREFIX_NEW = 96, (8, 16, 24, 32), \
    16, 16


def moe_cfg():
    """paper-moe-100m with the fused gating and dispatch flags on."""
    from repro_torch.configs import get_arch
    return fused_moe(get_arch("paper-moe-100m"))


def force_arm(eng, arm) -> None:
    """Pin every decode tick of ``eng`` to ``arm``, past the engine's cost
    decision (as tests/test_serve_differential.py forces it)."""
    orig = eng.engine.choose_serve_tick

    def forced(*a, **k):
        mode = orig(*a, **k)
        return arm if mode.startswith(("decode", "spec")) \
            and k.get("spec_len", 0) > 1 else mode

    eng.engine.choose_serve_tick = forced


def graph_launches(graphs, since, keep=None) -> dict:
    """The kernel launches that the replays of ``graphs`` ({name:
    GraphedStep}) credited since ``since`` ({name: replays}); with
    ``keep``, only those of the graphs whose name it accepts."""
    from repro_torch.kernels import LAUNCHES
    want = dict.fromkeys(LAUNCHES, 0)
    for name, g in graphs.items():
        if keep is not None and not keep(name):
            continue
        for k, n in g.per_replay.items():
            want[k] += (g.replays - since.get(name, 0)) * n
    return want


def serve_engine(cfg, params, dev, **kw):
    """An 8-slot engine of the serve phases.  The phases before [compact]
    run every tick at the pool's full height (``compact_decode=False``):
    [compact] measures how a compact tick rounds."""
    from repro_torch.engine import ServeEngine
    kw.setdefault("compact_decode", False)
    return ServeEngine(cfg, params, max_len=SERVE_MAX_LEN,
                       slots=SERVE_SLOTS, prefill_chunk=16, decode_chunk=4,
                       device=dev, **kw)


def timed_generate(torch, eng, prompts, max_new):
    """Serve ``prompts`` (``max_new`` new tokens each, or a list of one
    count a prompt) with the launch counts set to 0 just before and read
    just after: (requests, wall seconds, launches)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, n) for p, n in zip(prompts, news)]
    eng.run_until_done()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0, dict(LAUNCHES)


def spec_phase(torch, dev, cfg, srv, static, fails) -> None:
    """The decode arms, each forced on every decode tick of its own engine
    (after a warm-up that captures its graphs): plain, spec:ngram,
    spec:draft with the truncated self-draft, and spec:draft with the
    target as its own draft; then one unforced serve and the arms the
    engine chose.  Each serves the 8 [serve]-length motif prompts on 8
    slots: its launches are exactly the replays of both graphs times their
    per-replay counts, and its output equals generate_static's.  The
    oracle (``StaticOracle``) runs each prompt in a 4-row batch: cuBLAS
    rounds a one-row product (a GEMV) differently from a product of 4 or
    8 rows, which leads to near-tie flips at full depth, and 4 tokens fill
    one expert slot's capacity of 4 at most, so nothing drops.  The
    target as draft accepts every proposal."""
    from collections import Counter
    rng = np.random.default_rng(SEED + 1)
    prompts = [np.tile(rng.integers(1, cfg.vocab, MOTIF),
                       -(-n // MOTIF))[:n].astype(np.int32)
               for n in PROMPT_LENS]
    t0 = time.perf_counter()
    static.prefetch([(p, MAX_NEW) for p in prompts])
    oracle = np.stack([static(p, MAX_NEW) for p in prompts])
    log(f"[spec] oracle: generate_static's 4-row loop on each prompt, "
        f"{time.perf_counter() - t0:.4f} s")
    arms = (("plain", None, {}), ("ngram", "spec:ngram", {}),
            ("self-draft", "spec:draft", {"draft": "self"}),
            ("target-draft", "spec:draft",
             {"draft_cfg": cfg, "draft_params": srv.params}),
            ("unforced", None, {"draft": "self"}))
    for name, arm, kw in arms:
        eng = serve_engine(cfg, srv.params, dev,
                           spec_decode=name != "plain", **kw)
        if arm:
            force_arm(eng, arm)
        eng.generate([p[:16] for p in prompts], 8)     # captures the graphs
        graphs = dict(eng._tick.graphs)
        since = {n: g.replays for n, g in graphs.items()}
        spec0 = {a: dict(c) for a, c in eng.spec_arms.items()}
        n_dec = len(eng.engine.decisions)
        reqs, wall, launches = timed_generate(torch, eng, prompts, MAX_NEW)
        out = np.stack([r.output() for r in reqs])
        if not np.array_equal(out, oracle):
            bad = np.argwhere(out != oracle)[:5].tolist()
            fails.append(f"spec {name}: output != generate_static at {bad}")
        if eng._tick.graphs != graphs or eng._tick.captures != len(graphs):
            fails.append(f"spec {name}: a graph was captured in the run")
        want = graph_launches(graphs, since)
        if launches != want:
            fails.append(f"spec {name}: launches {launches} are not the "
                         f"graphs' replays' {want}")
        if not all(launches[k] for k in ("moe_gating", "moe_dispatch",
                                         "moe_combine")):
            fails.append(f"spec {name}: an MoE kernel never launched")
        acc = {}
        for a, c in eng.spec_arms.items():
            c0 = spec0.get(a, {})
            acc[a] = {k: v - c0.get(k, 0) for k, v in c.items()}
        if name == "target-draft" and not (
                acc["draft"]["proposed"] and
                acc["draft"]["accepted"] == acc["draft"]["proposed"]):
            fails.append(f"spec {name}: the target as draft accepted "
                         f"{acc['draft']}")
        if arm and not acc.get(arm.split(":")[1], {}).get("proposed"):
            fails.append(f"spec {name}: no speculative tick ran")
        rates = {a: f"{c['accepted']}/{c['proposed']} accepted over "
                    f"{c['ticks']} ticks" for a, c in acc.items()
                 if c["ticks"]}
        log(f"[spec] {name}: {out.size / wall:.1f} generated tok/s "
            f"({wall:.4f} s, {eng.tick_no} ticks in all); speculation "
            f"{rates or 'none'}; replays "
            f"{ {n: g.replays - since[n] for n, g in graphs.items()} }, per "
            f"replay { {n: _nonzero(g.per_replay) for n, g in graphs.items()} }"
            f"; launches {_nonzero(launches)} (replays x per replay: "
            f"{'equal' if launches == want else want}); equals "
            f"generate_static {np.array_equal(out, oracle)}")
        if name == "unforced":
            chose = Counter(
                f"{d['decision']}={d['choice']}"
                for d in list(eng.engine.decisions)[n_dec:])
            log(f"[spec] unforced: the engine's choices in the run "
                f"{dict(sorted(chose.items()))}")
        del eng
        _free(torch)


def prefix_phase(torch, dev, cfg, srv, fails) -> None:
    """16 greedy requests sharing a 96-token prefix, served with the prefix
    cache off and on (each engine warmed up on an unrelated prompt): the
    outputs equal each other and generate_static, TTFT in both runs; then
    the same 16 again, every one answered from the result cache with no
    tick and no launch."""
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(1, cfg.vocab, PREFIX_LEN)
    lens = [PREFIX_SUFFIXES[i % len(PREFIX_SUFFIXES)]
            for i in range(PREFIX_REQS)]
    prompts = [np.concatenate([shared, rng.integers(1, cfg.vocab, n)])
               .astype(np.int32) for n in lens]
    oracle = np.zeros((PREFIX_REQS, PREFIX_NEW), np.int32)
    for n in PREFIX_SUFFIXES:
        idx = [i for i, m in enumerate(lens) if m == n]
        oracle[idx] = srv.generate_static(np.stack([prompts[i] for i in idx]),
                                          PREFIX_NEW)
    warm = rng.integers(1, cfg.vocab, (1, 40)).astype(np.int32)
    runs = {}
    for on in (False, True):
        eng = serve_engine(cfg, srv.params, dev, prefix_cache=on)
        eng.generate(warm, 4)
        graphs = dict(eng._tick.graphs)
        since = {n: g.replays for n, g in graphs.items()}
        reqs, wall, launches = timed_generate(torch, eng, prompts,
                                              PREFIX_NEW)
        want = graph_launches(graphs, since)
        if launches != want or eng._tick.graphs != graphs:
            fails.append(f"prefix {on}: launches {launches} are not the "
                         f"graph's replays' {want}")
        out = np.stack([r.output() for r in reqs])
        ttft = np.array([r.t_first - r.t_submit for r in reqs])
        runs[on] = (eng, out)
        st = eng.prefix.stats() if on else {}
        log(f"[prefix] cache {'on' if on else 'off'}: {PREFIX_REQS} "
            f"requests ({PREFIX_LEN}-token shared prefix, suffixes "
            f"{list(PREFIX_SUFFIXES)}), {PREFIX_NEW} new each: {wall:.4f} s, "
            f"{out.size / wall:.1f} generated tok/s, TTFT median "
            f"{np.median(ttft):.6f} s, largest {ttft.max():.6f} s; "
            f"{eng.tick_no} ticks; seeded {st.get('seeded')}, tokens "
            f"avoided {st.get('tokens_avoided')}, snapshots "
            f"{st.get('snapshots')}; launches {_nonzero(launches)} "
            f"({sum(g.replays - since[n] for n, g in graphs.items())} "
            f"replays); equals generate_static {np.array_equal(out, oracle)}")
    eng = runs[True][0]
    if not (np.array_equal(runs[False][1], oracle)
            and np.array_equal(runs[True][1], oracle)):
        fails.append("prefix: outputs differ from generate_static")
    if not eng.prefix.seeded:
        fails.append("prefix: no request was seeded")
    from repro_torch.kernels import LAUNCHES
    ticks0, hits0 = eng.tick_no, eng.prefix.result_hits
    reqs, wall, launches = timed_generate(torch, eng, prompts, PREFIX_NEW)
    out = np.stack([r.output() for r in reqs])
    hits = eng.prefix.result_hits - hits0
    ok = np.array_equal(out, oracle) and hits == PREFIX_REQS and \
        eng.tick_no == ticks0 and not any(LAUNCHES.values())
    log(f"[prefix] the same {PREFIX_REQS} again: {hits} result-cache hits, "
        f"{eng.tick_no - ticks0} ticks, launches {_nonzero(launches)}, "
        f"{wall:.6f} s; equal outputs {np.array_equal(out, oracle)}")
    if not ok:
        fails.append("prefix: the repeats were not all answered from the "
                     "result cache without a tick")
    del runs, eng
    _free(torch)


def publish_phase(torch, dev, cfg, srv, fails) -> None:
    """A weight publish mid-stream: ``update(params=<seed SEED+1's weights
    as host numpy>, params_version=1)`` while 3 requests are in flight; no
    request drops, requests admitted after the boundary equal a fresh
    engine on the new weights and run through the graph captured again on
    the new weights, and neither a version-0 answer nor a version-0
    snapshot serves after the bump."""
    from repro_torch.models import lm
    rng = np.random.default_rng(SEED + 3)
    p2 = lm.init(cfg, torch.Generator(device=dev).manual_seed(SEED + 1),
                 device=dev)
    host = {k: {n: v.cpu().numpy() for n, v in t.items()}
            if isinstance(t, dict) else t.cpu().numpy()
            for k, t in p2.items()}
    fresh = serve_engine(cfg, p2, dev)
    del p2
    shared = rng.integers(1, cfg.vocab, 32)
    first = [np.concatenate([shared, rng.integers(1, cfg.vocab, n)])
             .astype(np.int32) for n in (8, 24, 40, 56)]
    post = [np.concatenate([shared, rng.integers(1, cfg.vocab, n)])
            .astype(np.int32) for n in (16, 32, 48)]
    eng = serve_engine(cfg, srv.params, dev, prefix_cache=True)
    eng.generate(rng.integers(1, cfg.vocab, (1, 40)).astype(np.int32), 4)
    pre = eng.submit(first[0], 16)      # its answer is stored at version 0
    eng.run_until_done()
    from repro_torch.kernels import LAUNCHES, reset_launches
    g0, caps0 = eng._tick.graphed, eng._tick.captures
    since = g0.replays
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    straddlers = [eng.submit(p, MAX_NEW) for p in first[1:]]
    for _ in range(3):
        eng.tick()
    in_flight = sum(not r.done.is_set() for r in straddlers)
    eng.update(params=host, params_version=1)
    hits0 = eng.prefix.result_hits
    late = [eng.submit(p, 16) for p in post + [first[0]]]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    g1 = eng._tick.graphed
    # each replay credits its capture's counts, and the capture on the new
    # weights ran one eager warm-up step of the same launches
    recaptured = eng._tick.captures - caps0
    want = {k: n * (g0.replays - since + g1.replays + recaptured)
            for k, n in g0.per_replay.items()}
    want_out = fresh.generate(post + [first[0]], 16)
    out = np.stack([r.output() for r in late])
    stale = [n.version for n in eng.prefix._snapshot_nodes()
             if n.version != 1]
    dropped = [r.rid for r in [pre] + straddlers + late
               if not (r.done.is_set() and len(r.tokens) >= r.max_new)]
    log(f"[publish] {in_flight} requests in flight at the publish, "
        f"{len(late)} admitted after it ({wall:.4f} s in all): params "
        f"version {eng.params_version}; the tick's graph captured again "
        f"{recaptured} time(s) on the new weights (the weights are rebound, "
        f"not copied into), {g1.replays} replays after it; launches "
        f"{_nonzero(launches)} ({'equal to' if launches == want else 'not'}"
        f" the replays and the capture's warm-up x per replay); dropped "
        f"{dropped}; after the boundary equal to a fresh engine on the new "
        f"weights {np.array_equal(out, want_out)}; result hits after the "
        f"bump {eng.prefix.result_hits - hits0}; snapshots of another "
        f"version {len(stale)} of {eng.prefix.snapshots}")
    if dropped or in_flight == 0:
        fails.append(f"publish: dropped {dropped}, in flight {in_flight}")
    if not np.array_equal(out, want_out):
        fails.append("publish: requests after the boundary differ from a "
                     "fresh engine on the new weights")
    if recaptured != 1 or g1 is g0 or not g1.replays or launches != want:
        fails.append(f"publish: graph recaptured {recaptured}, replays "
                     f"{g1.replays}, launches {launches} vs {want}")
    if eng.prefix.result_hits != hits0 or stale or \
            eng.params_version != 1:
        fails.append("publish: a version-0 answer or snapshot survived")
    del eng, fresh
    _free(torch)


# [pools], [compact], [autotune]: several slot pools arbitrated across
# priority classes, compact decode and the knob autotuner, on paper-moe-100m
# at full width (the [serve] model, random weights from SEED)
POOLS, POOL_SLOTS = 2, 4
# the reference gauntlet's two-class table for priority_starvation
# (benchmarks/gauntlet.py _STARVE_CLASSES), copied: (name, weight,
# max_defer)
STARVE_CLASSES = (("interactive", 4.0, 2), ("batch", 1.0, 6))
# batch traffic only on pool 1; interactive may join either pool
POOL_ROUTES = {"batch": (1,)}
POOL_SCENARIOS = ("priority_starvation", "steady_poisson")
MOE_KERNELS = ("moe_gating", "moe_dispatch", "moe_combine")
# [compact]: 2 requests decode on the 8 slots
COMPACT_LEN, COMPACT_NEW = 64, 64


def pool_cfg(cfg):
    from repro_torch.configs.base import PriorityClass
    return dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, classes=tuple(PriorityClass(n, w, d)
                                 for n, w, d in STARVE_CLASSES)))


def scenario_stream(name, cfg):
    """The reference scenario's request stream from SEED, its prompt
    lengths scaled to the [serve] prompts' 16-128 tokens and its tokens to
    the model's vocabulary (arrivals, response budgets and the class mix
    as the scenario has them)."""
    from repro_torch.engine import loadgen as lg
    spec = dataclasses.replace(
        lg.SCENARIOS[name], vocab=cfg.vocab,
        plen_params=(("lo", min(PROMPT_LENS)), ("hi", max(PROMPT_LENS))))
    return spec, lg.generate(spec, SEED)


class StaticOracle:
    """``generate_static``'s greedy loop over ``rows`` rows (4, a pool's
    height: cuBLAS rounds by rows), independent of the engine's scheduling,
    memoized by (prompt, new tokens); ``seconds`` sums its wall.

    The loop is ``BatchedServer.generate_static``'s step (``lm.decode_step``,
    the rows one MoE group) captured once in a CUDA graph and replayed a
    token, with a request in each row, each at its own position: a row
    feeds its prompt, then its own greedy tokens.  Each row's attention
    reads its own cache, and the group routes its tokens x top-2 into a
    capacity of at least 4 (a slot takes at most one assignment a token),
    so nothing drops and a row's tokens are those of ``generate_static``
    on copies of its prompt; the first ``CHECKED`` requests are held to
    that eager loop token for token in the run.
    ``margins`` runs the eager loop keeping each step's top-2 logit margin,
    for a request that parts from it."""

    CHECKED = 2

    def __init__(self, torch, srv, fails, rows=4, tag="oracle"):
        self.torch, self.srv, self.fails = torch, srv, fails
        self.ROWS, self.tag = rows, tag
        self.memo, self.seconds, self.checked = {}, 0.0, 0
        self.graph = None

    @staticmethod
    def key(prompt, max_new):
        return (tuple(int(t) for t in prompt), int(max_new))

    def __call__(self, prompt, max_new):
        self.prefetch([(prompt, max_new)])
        return self.memo[self.key(prompt, max_new)]

    def _capture(self):
        """The 4-row state, the step's static token input and its graph
        (an eager step first, on a side stream, then every row zeroed)."""
        from repro_torch.models import lm
        torch, srv = self.torch, self.srv
        state = lm.init_cache(srv.cfg, self.ROWS, srv.max_len,
                              device=srv.device)
        tok = torch.zeros((self.ROWS, 1), dtype=torch.long,
                          device=srv.device)

        def step():
            logits, st = srv._step(srv.params, state, tok)
            state["pos"].copy_(st["pos"])
            return torch.argmax(logits, dim=-1)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            greedy = step()
        self.graph, self.state, self.tok, self.greedy = (graph, state, tok,
                                                         greedy)

    def _batch(self, items):
        """The greedy tokens of up to ``ROWS`` (prompt, new tokens)
        requests, one in each row (a short batch's last request fills the
        other rows)."""
        torch = self.torch
        items = items + [items[-1]] * (self.ROWS - len(items))
        if self.graph is None:
            self._capture()
        for leaves in self.state["caches"].values():
            for c in leaves.values():
                c.zero_()
        self.state["pos"].zero_()
        lens = [len(p) for p, _ in items]
        steps = max(n + m for n, (_, m) in zip(lens, items)) - 1
        pad = np.zeros((self.ROWS, max(lens)), np.int64)
        for r, (p, _) in enumerate(items):
            pad[r, :len(p)] = p
        dev = self.tok.device
        ptoks = torch.as_tensor(pad, device=dev)
        plen = torch.as_tensor(lens, device=dev)
        prev = ptoks[:, 0]
        outs = []
        for i in range(steps):
            feed = ptoks[:, i] if i < ptoks.shape[1] else prev
            self.tok.copy_(torch.where(i < plen, feed, prev)[:, None])
            self.graph.replay()
            prev = self.greedy.clone()
            outs.append(prev)
        host = torch.stack(outs, 1).cpu().numpy().astype(np.int32)
        return [host[r, n - 1:n - 1 + m]
                for r, (n, (_, m)) in enumerate(zip(lens, items))]

    def prefetch(self, items):
        """Compute every request of ``items`` not yet memoized, ``ROWS`` a
        batch."""
        todo, seen = [], set()
        for p, m in items:
            k = self.key(p, m)
            if k not in self.memo and k not in seen:
                seen.add(k)
                todo.append((np.asarray(p, np.int64), int(m)))
        if not todo:
            return
        t0 = time.perf_counter()
        for i in range(0, len(todo), self.ROWS):
            batch = todo[i:i + self.ROWS]
            for (p, m), out in zip(batch, self._batch(batch)):
                self.memo[self.key(p, m)] = out
        self.seconds += time.perf_counter() - t0
        for p, m in todo[:max(self.CHECKED - self.checked, 0)]:
            eager = self.srv.generate_static(
                np.repeat(p.astype(np.int32)[None], self.ROWS, 0), m)[0]
            same = np.array_equal(eager, self.memo[self.key(p, m)])
            self.checked += 1
            log(f"[{self.tag}] the graphed {self.ROWS}-row oracle against "
                f"the eager generate_static on {self.ROWS} copies, request "
                f"{self.checked} "
                f"({len(p)} prompt tokens, {m} new): "
                f"{'equal' if same else 'DIFFERENT'}")
            if not same:
                self.fails.append(f"{self.tag}: the graphed static oracle "
                                  f"parts from generate_static on request "
                                  f"{self.checked}")

    def margins(self, prompt, max_new, top2=False):
        """``[max_new]`` top-2 margins of the static loop on the prompt,
        with ``top2`` also its ``[max_new, 2]`` top-2 logits."""
        _, m, t = static_margins(self.torch, self.srv,
                                 [np.asarray(prompt, np.int32)] * self.ROWS,
                                 max_new)
        return (m[0], t[0]) if top2 else m[0]


def pool_server(cfg, srv, dev, **kw):
    """2 pools x 4 slots of the two-class table, every tick at its pool's
    full height unless ``compact_decode`` says otherwise."""
    from repro_torch.runtime.serve import BatchedServer
    kw.setdefault("compact_decode", False)
    return BatchedServer(pool_cfg(cfg), srv.params, max_len=SERVE_MAX_LEN,
                         slots=POOL_SLOTS, pools=POOLS,
                         class_pools=POOL_ROUTES, device=dev, **kw)


def warm_pools(torch, eng, cfg, rng) -> list:
    """One request pinned to each pool in turn: each pool's first tick
    captures its graph.  Returns each pool's (seconds, MiB reserved) of
    that first serve."""
    out = []
    for lid in range(len(eng.pools)):
        torch.cuda.synchronize()
        r0, t0 = torch.cuda.memory_reserved(), time.perf_counter()
        eng.submit(rng.integers(1, cfg.vocab, 16).astype(np.int32), 4,
                   pool=lid)
        eng.run_until_done()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0,
                    (torch.cuda.memory_reserved() - r0) / 2 ** 20))
    return out


def drive_scenario(torch, psrv, name, cfg):
    """``loadgen.drive`` of the scenario through ``BatchedServer.submit``
    (a request of the scenario's single default class is served as the
    table's first class).  Returns (spec, drive result, wall seconds)."""
    from repro_torch.engine import loadgen as lg
    spec, gen = scenario_stream(name, cfg)
    eng = psrv.engine()

    def submit(prompt, max_new, temperature, priority):
        return psrv.submit(prompt, max_new, temperature,
                           priority=priority if priority in eng.classes
                           else None)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lg.drive(eng, gen, max_ticks=20_000, submit=submit)
    torch.cuda.synchronize()
    return spec, res, time.perf_counter() - t0


def class_report(tag, name, spec, res, wall, oracle, fails,
                 allow=None) -> list:
    """Per class: TTFT median and largest in virtual ticks and in seconds,
    generated tok/s, max_deferred against the class's bound; the
    scenario's SLO grade; greedy outputs equal to the static oracle's, or
    with ``allow`` (a run whose ticks may be compact) equal except from a
    token where the oracle's top-2 margin is within ``allow``.  Returns
    those partings' (request, token, margin)."""
    from repro_torch.core.scheduler import grade_slo
    from repro_torch.engine import loadgen as lg
    # choose_serve_job serves one pool a tick, most overdue first: when
    # the POOLS pools' prefills reach max_defer in the same round, the
    # last one served waits POOLS - 1 ticks past it (the reference's
    # engine alike; tests/test_torch_serve_priority.py
    # test_aging_bound_with_both_pools_aging_at_once)
    bound = {n: d + POOLS - 1 for n, _, d in STARVE_CLASSES}
    by = {}
    for tr in res.traces:
        by.setdefault(tr.req.priority, []).append(tr)
    for cls, trs in sorted(by.items()):
        ticks = [tr.ttft for tr in trs]
        secs = [tr.req.t_first - tr.req.t_submit for tr in trs]
        toks = sum(len(tr.req.output()) for tr in trs)
        md = max(tr.req.max_deferred for tr in trs)
        log(f"[{tag}] {name} {cls}: {len(trs)} requests, TTFT median "
            f"{np.median(ticks)} and largest {max(ticks)} ticks, median "
            f"{np.median(secs):.6f} and largest {max(secs):.6f} s; "
            f"{toks / wall:.1f} generated tok/s; max_deferred {md} (bound "
            f"{bound[cls]}: max_defer + {POOLS - 1} for {POOLS} pools)")
        if md > bound[cls]:
            fails.append(f"{tag} {name}: class {cls} deferred {md} ticks, "
                         f"over its bound {bound[cls]}")
    m = lg.summarize(res)
    ok, detail = grade_slo(m, list(spec.slos))
    log(f"[{tag}] {name}: {len(res.traces)} requests, {res.ticks} virtual "
        f"ticks ({res.idle_skipped} fast-forwarded), {wall:.4f} s, "
        f"{res.tokens_out / wall:.1f} generated tok/s; dropped "
        f"{m['dropped']}; the scenario's SLOs (smoke-scale tripwires) "
        f"{'pass' if ok else 'fail'} {detail}")
    bad, near = [], []
    oracle.prefetch([(tr.gen.prompt, tr.gen.max_new) for tr in res.traces])
    for tr in res.traces:
        want = oracle(tr.gen.prompt, tr.gen.max_new)
        out = tr.req.output()
        if np.array_equal(out, want):
            continue
        if allow is None or len(out) != len(want):
            bad.append(tr.req.rid)
            continue
        margins = oracle.margins(tr.gen.prompt, tr.gen.max_new)
        near += [(tr.req.rid,) + x[1:] for x in near_tie_check(
            f"{tag} {name}, request {tr.req.rid}", out[None], want[None],
            margins[None], allow, fails)]
    if allow is not None:
        log(f"[{tag}] {name}: (request, token, static top-2 margin) where a "
            f"request parts from generate_static at a near-tie within "
            f"{allow}: {near}")
    if bad or m["dropped"]:
        fails.append(f"{tag} {name}: requests {bad[:5]} differ from "
                     f"generate_static, {m['dropped']} dropped")
    return near


def pool_graphs(eng, since) -> dict:
    """Per pool: its graphs' captures and replays since ``since``."""
    out = {}
    for (lid, n, rows), g in eng._tick.graphs.items():
        p = out.setdefault(f"pool {lid}", {"graphs": [], "replays": 0})
        p["graphs"].append(f"{n}@{rows}")
        p["replays"] += g.replays - since.get((lid, n, rows), 0)
    return out


def step_inputs(torch, cfg, params, dev, rng, pool):
    """The MoE kernels' inputs of the tick's decode step over ``pool`` (its
    rows all active): four eager runs, the last call of each kept."""
    from repro_torch.engine.serve import build_decode_step
    step = build_decode_step(cfg, dev)
    active = torch.ones(pool.slots, dtype=torch.bool, device=dev)

    @torch.no_grad()
    def run():
        for _ in range(4):
            tok = torch.as_tensor(rng.integers(1, cfg.vocab, pool.slots),
                                  device=dev)
            step(params, None, pool, tok, active)
    return capture_kernel_inputs(torch, run)[1]


def suffixed(rows, tag) -> list:
    for r in rows:
        r["name"] = f"{r['name']}@{tag}"
    return rows


def pools_phase(torch, dev, cfg, srv, oracle, fails) -> list:
    """2 pools x 4 slots and the two-class table (batch traffic on pool 1
    only), driven by loadgen over priority_starvation and steady_poisson:
    per class TTFT, tok/s and max_deferred within its bound, greedy ==
    generate_static, every launch one that a replay of a pool's graph made
    (counts set to 0 just before each drive and read just after), then the
    device's busy share under a CUDA-only trace, and the MoE kernels on
    pool 1's rows against their plain versions.  Returns their JSON rows."""
    from repro_torch.engine.serve import SlotPool
    from repro_torch.kernels import LAUNCHES, reset_launches
    rng = np.random.default_rng(SEED + 4)
    psrv = pool_server(cfg, srv, dev)
    eng = psrv.engine()
    warm = warm_pools(torch, eng, cfg, rng)
    caps0 = eng._tick.captures
    log(f"[pools] {POOLS} pools x {POOL_SLOTS} slots, classes "
        f"{STARVE_CLASSES} (name, weight, max_defer), routes {POOL_ROUTES}; "
        f"each pool's first serve (its graph's capture in it): "
        + "; ".join(f"pool {i} {s:.4f} s, {mib:.1f} MiB reserved"
                    for i, (s, mib) in enumerate(warm)))
    # each pool's launches: its own graphs' replays x per-replay counts
    per_pool = [dict.fromkeys(LAUNCHES, 0) for _ in range(POOLS)]
    walls = {}
    for name in POOL_SCENARIOS:
        since = {k: g.replays for k, g in eng._tick.graphs.items()}
        reset_launches()
        spec, res, wall = drive_scenario(torch, psrv, name, cfg)
        launches = dict(LAUNCHES)
        want = graph_launches(eng._tick.graphs, since)
        mine = [graph_launches(eng._tick.graphs, since,
                               lambda key, lid=lid: key[0] == lid)
                for lid in range(POOLS)]
        class_report("pools", name, spec, res, wall, oracle, fails)
        log(f"[pools] {name}: per pool {pool_graphs(eng, since)}; launches "
            f"{_nonzero(launches)} (replays x per replay: "
            f"{'equal' if launches == want else want}); of them by pool "
            + "; ".join(f"{lid}: {_nonzero(m)}" for lid, m in enumerate(mine)))
        if launches != want or eng._tick.captures != caps0:
            fails.append(f"pools {name}: launches {launches} are not the "
                         f"replays' {want}, or a graph was captured")
        for lid, m in enumerate(mine):
            for k, n in m.items():
                per_pool[lid][k] += n
        walls[name] = wall
    for lid, m in enumerate(per_pool):
        if not all(m[k] for k in MOE_KERNELS):
            fails.append(f"pools: pool {lid}'s graphs launched "
                         f"{_nonzero(m)}, not every MoE kernel")
    log(f"[pools] the static oracle: {len(oracle.memo)} prompts, "
        f"{oracle.seconds:.1f} s (4 requests a batch, a graph replay a "
        f"token)")
    # the first scenario's work once more under a CUDA-only trace
    ticks0 = eng.tick_no
    wall_t, busy_us, _, _ = device_trace(
        torch, lambda: drive_scenario(torch, psrv, POOL_SCENARIOS[0], cfg))
    untraced = walls[POOL_SCENARIOS[0]]
    busy = busy_us / 1e6 / untraced
    log(f"[profile] pools: {POOL_SCENARIOS[0]} again under a CUDA-only "
        f"trace ({eng.tick_no - ticks0} ticks, traced wall {wall_t:.4f} s): "
        f"device busy {busy_us:.0f} us; over the untraced drive's wall "
        f"{untraced:.4f} s: busy {busy:.4f}, idle {1 - busy:.4f}")
    # the MoE kernels on pool 1's rows (a copy of its state, all rows on)
    copy = SlotPool(cfg, POOL_SLOTS, SERVE_MAX_LEN, dev)
    eng.pools[1].gather_into(copy, torch.arange(POOL_SLOTS, device=dev))
    rows, shapes = check_kernels(
        torch, step_inputs(torch, cfg, psrv.params, dev, rng, copy),
        per_pool[1])
    log_kernel_rows(suffixed(rows, "pool1"), shapes)
    del eng, psrv, copy
    _free(torch)
    return rows


LAYOUT = {False: "full", True: "compact", None: "unforced"}


def static_margins(torch, srv, prompts, max_new):
    """generate_static's greedy loop on ``prompts`` (equal lengths) as one
    batch, keeping each step's top-2 logits: (tokens, margins), each
    ``[B, max_new]``, and the top-2 logits ``[B, max_new, 2]``."""
    from repro_torch.models import lm
    state = lm.init_cache(srv.cfg, len(prompts), srv.max_len,
                          device=srv.device)
    toks = torch.as_tensor(np.stack(prompts), dtype=torch.long,
                           device=srv.device)
    out, margins, tops = [], [], []
    with torch.no_grad():
        for i in range(toks.shape[1]):
            logits, state = srv._step(srv.params, state, toks[:, i:i + 1])
        for _ in range(max_new):
            top2 = torch.topk(logits.float(), 2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
            tops.append(top2)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            logits, state = srv._step(srv.params, state, tok[:, None])
    return (torch.stack(out, 1).cpu().numpy().astype(np.int32),
            torch.stack(margins, 1).cpu().numpy(),
            torch.stack(tops, 1).cpu().numpy())


def height_drift(torch, cfg, params, dev, prompts, ref) -> dict:
    """The rounding a compact tick adds, measured apart from the served
    runs: ``prompts`` (4 of COMPACT_LEN tokens) fed one step a token to
    rows 0-3 of an 8-row pool (rows 4-7 idle, as in a tick), then for each
    height h of 1, 2 and 4 the eager decode step over a copy of the 8 rows
    and over a buffer set of h rows gathered from them, both fed the
    static loop's greedy tokens ``ref`` [4, n] (the requests' own
    trajectory, as the runs follow it until they part).  Returns {h: the
    largest logit difference over rows 0..h-1 and the n - 1 steps}."""
    from repro_torch.engine.serve import SlotPool, build_decode_step
    step = build_decode_step(cfg, dev)
    n = len(prompts)
    every = torch.arange(SERVE_SLOTS, device=dev)
    on = every < n

    def toks(col):
        t = torch.zeros(SERVE_SLOTS, dtype=torch.long, device=dev)
        t[:n] = torch.as_tensor(np.asarray(col), device=dev)
        return t

    base = SlotPool(cfg, SERVE_SLOTS, SERVE_MAX_LEN, dev)
    drift = {}
    with torch.no_grad():
        for i in range(COMPACT_LEN):
            step(params, None, base, toks([p[i] for p in prompts]), on)
        for h in (1, 2, 4):
            full = SlotPool(cfg, SERVE_SLOTS, SERVE_MAX_LEN, dev)
            base.gather_into(full, every)
            sub = base.compact_rows(h)
            base.gather_into(sub, every[:h])
            d = torch.zeros((), device=dev)
            for t in range(ref.shape[1] - 1):
                tok = toks(ref[:, t])
                a, _ = step(params, None, full, tok, on)
                b, _ = step(params, None, sub, tok[:h], on[:h])
                d = torch.maximum(d, (a[:h].float() - b.float()).abs().max())
            drift[h] = d.item()
    return drift


def near_tie_check(tag, out, ref, margins, diff, fails) -> list:
    """Tokens ``out`` equal ``ref`` row by row, except from a row's first
    difference where the reference's top-2 margin is within ``diff`` (a
    number, or one a token as ``margins``; the row is compared no
    further).  Returns those rows' (row, token, margin)."""
    near = []
    for r in range(ref.shape[0]):
        bad = np.flatnonzero(out[r] != ref[r])
        if not bad.size:
            continue
        m = float(margins[r, bad[0]])
        lim = float(diff if np.isscalar(diff) else diff[r, bad[0]])
        if m <= lim:
            near.append((r, int(bad[0]), m))
        else:
            fails.append(f"{tag}: row {r} differs at token {bad[0]}, "
                         f"margin {m} > {lim}")
    return near


def compact_phase(torch, dev, cfg, srv, fails):
    """8 slots.  First the rounding a compact tick adds, measured apart
    from the served runs (``height_drift``): the allowance of every
    near-tie below.  Then 2 requests decoding: forced full, forced compact
    (ticks of 2 rows) and left to Engine.choose_compact, each after a
    warm-up that captures its graphs, launch counts set to 0 just before
    and read just after each run; the per-token tick EMAs of each layout;
    the served runs' largest logit difference until a row's argmax parts,
    beside the allowance.  Then 4 requests of 64, 48, 32 and 16 new tokens,
    forced full and forced compact (ticks of 4, 2 and 1 rows), each served
    twice on one engine and read the second time: its launches equal the
    replays of each height's graph times its per-replay counts, and each
    compact height's graph launched every MoE kernel.  The full runs equal
    generate_static; a compact run equals its full run, except from a
    token where the static loop's top-2 margin is within the allowance
    (cuBLAS may round a few rows unlike 8).  Then the MoE kernels at
    compact heights 1 and 2 against their plain versions, with the
    launches of those heights' graphs.  Returns (their JSON rows, the
    allowance: the largest drift of any height)."""
    from collections import Counter

    from repro_torch.engine.jobs import layout_kind
    from repro_torch.engine.serve import SlotPool
    rng = np.random.default_rng(SEED + 5)
    prompts = [rng.integers(1, cfg.vocab, COMPACT_LEN).astype(np.int32)
               for _ in range(4)]
    ref, margins, _ = static_margins(torch, srv, prompts, COMPACT_NEW)
    drift = height_drift(torch, cfg, srv.params, dev, prompts, ref)
    allow = max(drift.values())
    log(f"[compact] the eager decode step over 1, 2 or 4 of 8 rows against "
        f"the 8-row step, both fed the static loop's tokens after one "
        f"prefill of the 4 prompts: largest logit difference over "
        f"{COMPACT_NEW - 1} steps {drift} (the near-tie allowance: height "
        f"2's for the 2-request runs, the largest, {allow}, elsewhere)")
    runs = {}
    for mode in (False, True, None):
        eng = serve_engine(cfg, srv.params, dev, compact_decode=mode)
        eng.generate([p[:16] for p in prompts[:2]], 8)   # captures graphs
        graphs = dict(eng._tick.graphs)
        since = {k: g.replays for k, g in graphs.items()}
        n_dec = len(eng.engine.decisions)
        eng._tick.record = []
        reqs, wall, launches = timed_generate(torch, eng, prompts[:2],
                                              COMPACT_NEW)
        want = graph_launches(graphs, since)
        if launches != want or eng._tick.graphs != graphs:
            fails.append(f"compact {mode}: launches {launches} are not the "
                         f"replays' {want}, or a graph was captured")
        if not all(launches[k] for k in MOE_KERNELS):
            fails.append(f"compact {mode}: an MoE kernel never launched")
        est = {lay: eng.engine.costs.estimate(layout_kind(lay, 0) +
                                              "_per_tok")
               for lay in (True, False)}
        chose = Counter(d["choice"] for d in
                        list(eng.engine.decisions)[n_dec:]
                        if d["decision"] == "serve_compact")
        log(f"[compact] 2 requests, {LAYOUT[mode]}: "
            f"{2 * COMPACT_NEW / wall:.1f} generated tok/s ({wall:.4f} s), "
            f"{eng.compact_ticks} compact ticks of {eng.tick_no}; per-token "
            f"tick EMA compact {est[True]}, full {est[False]} s; graphs "
            f"{sorted(f'{n}@{r}' for (_, n, r) in graphs)}; launches "
            f"{_nonzero(launches)}"
            + (f"; choose_compact chose {dict(chose)} in the run, and after "
               f"it chooses "
               f"{'compact' if eng.engine.choose_compact(0) else 'full'}"
               if mode is None else ""))
        runs[mode] = (np.stack([r.output() for r in reqs]),
                      eng._tick.record)
        del eng
    full, rec_full = runs[False]
    if not np.array_equal(full, ref[:2]):
        fails.append(f"compact: the full run differs from generate_static "
                     f"at {np.argwhere(full != ref[:2])[:5].tolist()}")
    for mode in (True, None):
        out, rec = runs[mode]
        # the two requests are slots 0 and 1 (a compact tick's rows 0 and
        # 1), both in every tick: compare each row's logits step by step
        # until its argmax parts
        diff, parted = 0.0, set()
        for a, b in zip(rec_full, rec):
            for r in set(range(2)) - parted:
                diff = max(diff, (a[r].float() - b[r].float()).abs().max()
                           .item())
                if a[r].argmax() != b[r].argmax():
                    parted.add(r)
        near = near_tie_check(f"compact {mode}", out, full, margins[:2],
                              drift[2], fails)
        log(f"[compact] 2 requests, {LAYOUT[mode]} vs full: "
            f"{'bit-equal' if diff == 0 and not near else 'not bit-equal'}; "
            f"the served runs' largest logit difference until a row parts "
            f"{diff} over {len(rec)} steps (the eager drift at height 2: "
            f"{drift[2]}); (row, token, static top-2 margin) where a row "
            f"parts at a near-tie within {drift[2]}: {near}; tokens equal "
            f"{np.array_equal(out, full)}")
    # heights 4, 2 and 1: four requests ending at 16-token steps, served
    # once to capture each height's graph and read the second time
    news = [COMPACT_NEW - 16 * i for i in range(4)]
    outs, by_height = {}, {}
    for mode in (False, True):
        eng = serve_engine(cfg, srv.params, dev, compact_decode=mode)
        timed_generate(torch, eng, prompts, news)
        graphs = dict(eng._tick.graphs)
        since = {k: g.replays for k, g in graphs.items()}
        caps = eng._tick.captures
        reqs, wall, launches = timed_generate(torch, eng, prompts, news)
        outs[mode] = [r.output() for r in reqs]
        want = graph_launches(graphs, since)
        per = {key[2]: graph_launches(graphs, since,
                                      lambda k, key=key: k == key)
               for key in graphs if key[1] == "step"}
        log(f"[compact] 4 requests, {news} new, {LAYOUT[mode]}, served the "
            f"second time: {eng.compact_ticks} compact ticks of "
            f"{eng.tick_no} in both; launches {_nonzero(launches)} (replays "
            f"x per replay: {'equal' if launches == want else want}); of "
            f"them by the step graph's height "
            + "; ".join(f"{h}: {_nonzero(m)}" for h, m in sorted(per.items())))
        if launches != want or eng._tick.captures != caps:
            fails.append(f"compact heights {mode}: launches {launches} are "
                         f"not the replays' {want}, or a graph was captured")
        if mode:
            missing = [h for h in (1, 2, 4)
                       if not all(per.get(h, {}).get(k) for k in MOE_KERNELS)]
            if sorted(per) != [1, 2, 4, SERVE_SLOTS] or missing:
                fails.append(f"compact: step graphs at heights {sorted(per)}"
                             f", those of {missing} launched not every MoE "
                             f"kernel")
            by_height = per
        del eng
    near = []
    for r, n in enumerate(news):
        if not np.array_equal(outs[False][r], ref[r, :n]):
            fails.append(f"compact: the full run's request {r} differs "
                         f"from generate_static")
        near += [(r,) + x[1:] for x in near_tie_check(
            f"compact heights, request {r}", outs[True][r][None],
            outs[False][r][None], margins[r:r + 1, :n], allow, fails)]
    log(f"[compact] 4 requests, compact vs full: tokens equal "
        f"{all(np.array_equal(a, b) for a, b in zip(outs[True], outs[False]))}"
        f"; (request, token, static top-2 margin) where a request parts at "
        f"a near-tie within {allow}: {near}")
    # the MoE kernels at compact heights 1 and 2 (a compact tick's buffer
    # set is a pool of that many slots)
    rows = []
    for h in (1, 2):
        seen = step_inputs(torch, cfg, srv.params, dev, rng,
                           SlotPool(cfg, h, SERVE_MAX_LEN, dev))
        r, shapes = check_kernels(torch, seen, by_height.get(h) or
                                   dict.fromkeys(MOE_KERNELS, 0))
        rows += suffixed(r, f"compact{h}")
        log_kernel_rows(r, shapes)
    _free(torch)
    return rows, allow


def autotune_phase(torch, dev, cfg, srv, oracle, allow, fails) -> None:
    """The [pools] scenarios on a fresh 2-pool engine with
    ``autotune=True`` and the layout left to the engine
    (``compact_decode=None``: the default knobs prefill_chunk,
    compact_frac and the two class weights, in windows of 32 work ticks):
    the knob moves, the values they ended at, the ticks and compact ticks
    run under each setting, and greedy == generate_static except from a
    near-tie within ``allow`` ([compact]'s drift)."""
    from collections import Counter
    rng = np.random.default_rng(SEED + 6)
    psrv = pool_server(cfg, srv, dev, autotune=True, compact_decode=None)
    eng = psrv.engine()
    warm_pools(torch, eng, cfg, rng)
    # the ticks and compact ticks of each stretch between two knob moves:
    # the tuner applies a move through the engine's update handler, and
    # records the knob's new value after it (so a mark's ``current`` is the
    # setting of the stretch that the mark ends)
    marks, apply = [], eng._apply_updates

    def mark(updates=None):
        marks.append((dict(eng.autotuner.current), eng.tick_no,
                      eng.compact_ticks, updates))

    def moved(updates):
        if updates:                 # the engine applies its queue each tick
            mark(updates)
        return apply(updates)

    eng._apply_updates = moved
    mark()
    near = []
    for name in POOL_SCENARIOS:
        spec, res, wall = drive_scenario(torch, psrv, name, cfg)
        near += class_report("autotune", name, spec, res, wall, oracle,
                             fails, allow)
    mark()
    eng._apply_updates = apply
    snap = eng.autotuner.snapshot()
    moves = Counter(f"{d['knob']}={d['choice']}"
                    for d in eng.engine.decisions
                    if d["decision"] == "autotune_knob")
    stretches = [f"{b[0]}: {b[1] - a[1]} ticks, {b[2] - a[2]} compact, then "
                 f"{b[3]}" for a, b in zip(marks, marks[1:])]
    log(f"[autotune] {snap['windows']} windows of {snap['window']} work "
        f"ticks, {snap['moves']} moves; knob choices {dict(moves)}; ended "
        f"at {snap['current']}; captures {eng._tick.captures}; "
        f"{eng.compact_ticks} compact ticks of {eng.tick_no}; arm EMAs "
        f"(s/token) {snap['arms']}")
    log(f"[autotune] each setting the knobs held, with its ticks and compact "
        f"ticks and the move that ended it: {stretches}")
    if not snap["windows"]:
        fails.append("autotune: no window closed")
    del eng, psrv
    _free(torch)


# [migrate]: 12 requests on the [pools] server, pool 0 drained while pool 1
# is full, a pool joined the tick after
MIGRATE_REQS, MIGRATE_NEW = 12, 16


def row_bytes(pool) -> int:
    """Bytes of one slot's row of ``pool``: every row leaf and the
    position."""
    return sum(c.element_size() * c.numel() // c.shape[dim]
               for _, c, dim in pool.row_leaves()) + pool.pos.element_size()


def freeze_graphs(seen, graphs) -> None:
    """Keep in ``seen`` every graph ``graphs`` has held: a live one as it
    is, a dropped one as its final replay count and per-replay launches,
    so that ``seen`` keeps no retired pool alive."""
    from types import SimpleNamespace
    seen.update(graphs)
    for key, g in list(seen.items()):
        if key not in graphs and not isinstance(g, SimpleNamespace):
            seen[key] = SimpleNamespace(replays=g.replays,
                                        per_replay=dict(g.per_replay))


def migrate_phase(torch, dev, cfg, srv, oracle, fails) -> list:
    """Elastic pools and live slot migration on the [pools] server (2 pools
    x 4 slots, compact off): 12 requests (prompts cycling through the
    [serve] lengths, 16 new tokens each) take the 8 slots and 4 queue; once
    a pool-0 request has emitted a token pool 0 is drained while pool 1 is
    full, and the next tick a pool joins (lid 2, its graph captured on
    first use).  Checks: every request ≡ generate_static on 4 copies, none
    dropped, ``migrated_slots`` >= 1, pools [1, 2] left, no graph of pool 0
    left, pool 2 captured in the phase, pool 0 freed once retired, every
    MoE launch one that a replay made (or pool 2's capture's one eager
    warm-up step), per pool; the MoE kernels on pool 2's rows against
    their plain versions.  Logs each migration batch (engine-measured,
    and the move's device time by graph replay against its bytes bound),
    pool 2's first serve and the memory around pool 0's retirement.
    Returns the kernels' JSON rows and the prompts."""
    import weakref

    from repro_torch.engine.serve import SlotPool
    from repro_torch.kernels import LAUNCHES, reset_launches
    rng = np.random.default_rng(SEED + 7)
    psrv = pool_server(cfg, srv, dev)
    eng = psrv.engine()
    warm_pools(torch, eng, cfg, rng)
    prompts = [rng.integers(1, cfg.vocab, PROMPT_LENS[i % len(PROMPT_LENS)])
               .astype(np.int32) for i in range(MIGRATE_REQS)]
    # each migration batch as the engine ran it: (src, dst, rows,
    # positions, seconds with the device synchronised on both sides)
    batches, migrate = [], eng._migrate_slots

    def timed_migrate(src, dst, moves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pos = int(sum(src.pos_host[s] for s, _ in moves))
        migrate(src, dst, moves)
        torch.cuda.synchronize()
        batches.append((src.lid, dst.lid, len(moves), pos,
                        time.perf_counter() - t0))

    eng._migrate_slots = timed_migrate
    seen = dict(eng._tick.graphs)
    since = {k: g.replays for k, g in seen.items()}
    caps0 = eng._tick.captures
    pool0 = weakref.ref(eng._pool(0))
    pool0_bytes = POOL_SLOTS * row_bytes(eng._pool(0))
    drained = added = first_serve = retired = None
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [psrv.submit(p, MIGRATE_NEW) for p in prompts]
    for _ in range(20_000):
        if all(r.done.is_set() for r in reqs):
            break
        if drained is None and any(r.tokens for r in reqs if r.pool == 0):
            drained = eng.tick_no
            eng.drain_pool(0)
        elif drained is not None and added is None:
            torch.cuda.synchronize()
            r_add, t_add = torch.cuda.memory_reserved(), time.perf_counter()
            added = eng.add_pool()
        live0 = eng._pool(0) is not None
        if live0:
            torch.cuda.synchronize()
            mem0 = (torch.cuda.memory_allocated(),
                    torch.cuda.memory_reserved())
        assert eng.tick()
        freeze_graphs(seen, eng._tick.graphs)
        if added is not None and first_serve is None and any(
                k[0] == added for k in eng._tick.graphs):
            torch.cuda.synchronize()
            first_serve = (time.perf_counter() - t_add,
                           (torch.cuda.memory_reserved() - r_add) / 2 ** 20)
        if live0 and eng._pool(0) is None:
            gc.collect()
            torch.cuda.synchronize()
            retired = (eng.tick_no, mem0, (torch.cuda.memory_allocated(),
                                           torch.cuda.memory_reserved()),
                       pool0() is None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng._migrate_slots = migrate
    launches = dict(LAUNCHES)
    lids = sorted({k[0] for k in seen})
    per_pool = {lid: graph_launches(seen, since,
                                    lambda key, lid=lid: key[0] == lid)
                for lid in lids}
    # a capture in the phase ran its step once eagerly (all rows inactive)
    fresh = [g for k, g in seen.items() if k not in since]
    want = graph_launches(seen, since)
    for g in fresh:
        for k, n in g.per_replay.items():
            want[k] += n
    oracle.prefetch([(p, MIGRATE_NEW) for p in prompts])
    bad = [i for i, (p, r) in enumerate(zip(prompts, reqs))
           if not np.array_equal(r.output(), oracle(p, MIGRATE_NEW))]
    short = [i for i, r in enumerate(reqs) if len(r.output()) != MIGRATE_NEW]
    pools = [sp.lid for sp in eng.pools]
    log(f"[migrate] {MIGRATE_REQS} requests ({MIGRATE_NEW} new tokens each) "
        f"on {POOLS} pools x {POOL_SLOTS} slots; pool 0 drained at tick "
        f"{drained}, pool {added} joined at tick {drained + 1}; "
        f"{eng.tick_no} ticks in all, {wall:.4f} s, "
        f"{sum(len(r.output()) for r in reqs) / wall:.1f} generated tok/s; "
        f"migrated_slots {eng.migrated_slots}; pools left {pools}; "
        f"{len(reqs) - len(short)} of {len(reqs)} requests complete, "
        f"{len(reqs) - len(bad)} equal to generate_static")
    a = SlotPool(cfg, POOL_SLOTS, SERVE_MAX_LEN, dev)
    b = SlotPool(cfg, POOL_SLOTS, SERVE_MAX_LEN, dev)
    rb = row_bytes(a)
    for i, (src, dst, k, pos, secs) in enumerate(batches):
        idx = torch.arange(k, device=dev)
        ms = graph_ms(torch, lambda: a.move_rows(b, idx, idx))
        b_ms, _ = bound_ms(2 * k * rb, 0)
        log(f"[migrate] batch {i}: pool {src} -> pool {dst}, {k} rows "
            f"({pos} positions), {secs:.6f} s in the engine (synchronised, "
            f"host bookkeeping included); the move alone {ms:.6f} ms by "
            f"graph replay, bound {b_ms:.6f} ms by bytes ({k} rows x "
            f"{rb} B read and written at {HBM_BYTES_PER_S:.3g} B/s)")
    del a, b
    if first_serve is not None:
        log(f"[migrate] pool {added}'s first serve (add_pool to the end of "
            f"its first tick, its graph's capture in it): "
            f"{first_serve[0]:.4f} s, {first_serve[1]:.1f} MiB more reserved")
    if retired is not None:
        tick, (al0, rs0), (al1, rs1), freed = retired
        log(f"[migrate] pool 0 retired in tick {tick}: memory_allocated "
            f"{al0 / 2 ** 20:.1f} -> {al1 / 2 ** 20:.1f} MiB, "
            f"memory_reserved {rs0 / 2 ** 20:.1f} -> {rs1 / 2 ** 20:.1f} MiB "
            f"(pool 0's rows {pool0_bytes / 2 ** 20:.1f} MiB); its SlotPool "
            f"{'freed' if freed else 'still alive'}")
    log(f"[migrate] launches {_nonzero(launches)} (replays x per replay, and "
        f"one eager warm-up step per capture in the phase ({len(fresh)}): "
        f"{'equal' if launches == want else want}); by pool "
        + "; ".join(f"{lid}: {_nonzero(m)}" for lid, m in per_pool.items()))
    checks = {
        "requests differ from generate_static": bad,
        "requests incomplete": short,
        "no slot migrated": eng.migrated_slots < 1,
        f"pools left {pools}, not [1, 2]": pools != [1, 2],
        "a graph of pool 0 is left": any(k[0] == 0 for k in eng._tick.graphs),
        "pool 2 not captured in the phase":
            added != 2 or not any(k[0] == 2 for k in eng._tick.graphs)
            or eng._tick.captures == caps0,
        "pool 0 not retired, or still alive": retired is None or
            not retired[3],
        f"launches {launches} are not the replays' {want}": launches != want,
        "a pool's graphs launched not every MoE kernel": not all(
            m[k] for m in per_pool.values() for k in MOE_KERNELS),
    }
    for what, bad_ in checks.items():
        if bad_:
            fails.append(f"migrate: {what}" + (f": {bad_[:5]}"
                                               if isinstance(bad_, list)
                                               else ""))
    # the MoE kernels on pool 2's rows (a copy of its state, all rows on)
    copy = SlotPool(cfg, POOL_SLOTS, SERVE_MAX_LEN, dev)
    eng._pool(added).gather_into(copy, torch.arange(POOL_SLOTS, device=dev))
    rows, shapes = check_kernels(
        torch, step_inputs(torch, cfg, psrv.params, dev, rng, copy),
        per_pool[added])
    log_kernel_rows(suffixed(rows, f"pool{added}"), shapes)
    del eng, psrv, copy
    _free(torch)
    return rows, prompts


# [placed]: the [pools] server with both pools placed on the card, 8 of the
# [migrate] prompts (whose greedy oracle holds 16 new tokens: these take
# the first 12), pool 0 drained and a placed pool joined; then the same
# requests over two device-group keys on the one card
PLACED_REQS, PLACED_NEW = 8, 12
PLACED_BUDGET_S = 25.0


def alloc_bytes(tensors) -> int:
    """Bytes the caching allocator hands out for ``tensors``: each rounded
    up to its 512-byte blocks."""
    return sum(-(-t.numel() * t.element_size() // 512) * 512
               for t in tensors)


def placed_run(torch, eng, submit, prompts, card=None) -> tuple:
    """Serve ``prompts`` (PLACED_NEW new tokens each) on ``eng``; with
    ``card`` pool 0 is drained once a pool-0 request has emitted a token
    and a pool placed on ``card`` joins the next tick.  Returns (requests,
    wall seconds, the largest candidate ``load`` seen, every graph the
    run's ticks held, the drain's and the join's tick and lid)."""
    cands, loads = eng._candidates, [0.0]

    def logged():
        out = cands()
        loads.extend(c.load for c in out)
        return out

    eng._candidates = logged
    seen = dict(eng._tick.graphs)
    drained = added = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [submit(p, PLACED_NEW) for p in prompts]
    for _ in range(20_000):
        if all(r.done.is_set() for r in reqs):
            break
        if card and drained is None and any(r.tokens for r in reqs
                                            if r.pool == 0):
            drained = eng.tick_no
            eng.drain_pool(0)
        elif card and drained is not None and added is None:
            added = eng.add_pool(placement=[card])
        assert eng.tick()
        freeze_graphs(seen, eng._tick.graphs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng._candidates = cands
    return reqs, wall, max(loads), seen, drained, added


def placed_phase(torch, dev, cfg, srv, oracle, prompts, fails) -> list:
    """Device-placed pools on the card: see the module docstring's
    [placed].  Returns the MoE kernels' JSON rows on a placed pool's
    rows."""
    from repro_torch.engine.serve import SlotPool
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 9)
    prompts = prompts[:PLACED_REQS]
    want_tok = [oracle(p, MIGRATE_NEW)[:PLACED_NEW] for p in prompts]
    card = torch.device(dev.type, 0)
    placements = {0: f"{card}", 1: card}
    # a. placed on the card by two names of it: the engine and the placed
    # pools' weights allocate the pools' rows and the tick's routing plan,
    # and no second copy of the weights
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    psrv = pool_server(cfg, srv, dev, placements=placements)
    eng = psrv.engine()
    weights = [eng._params_for(sp)[0] for sp in eng.pools]
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    rows_b = sum(alloc_bytes([c for _, c, _ in sp.row_leaves()] + [sp.pos])
                 for sp in eng.pools)
    plan = moe_lib.identity_plan(cfg, lm.n_moe_layers(cfg), device="meta")
    plan_b = alloc_bytes([plan.slots, plan.cum])
    w_bytes = sum(t.numel() * t.element_size() for t in _leaves(eng.params))
    ptrs = [t.data_ptr() for t in _leaves(eng.params)]
    shared = all([t.data_ptr() for t in _leaves(w)] == ptrs for w in weights)
    log(f"[placed] a: 2 pools x {POOL_SLOTS} slots placed on {placements}; "
        f"memory_allocated grew {grown} B over the engine's construction "
        f"and its placed pools' weights (the pools' rows {rows_b} B, the "
        f"tick's routing plan {plan_b} B; the weights {w_bytes} B); the "
        f"placed pools read the engine's weight tensors: {shared}")
    warm_pools(torch, eng, cfg, rng)
    since = {k: g.replays for k, g in eng._tick.graphs.items()}
    n_dec = len(eng.engine.decisions)
    reset_launches()
    reqs, wall, load, seen, drained, added = placed_run(
        torch, eng, psrv.submit, prompts, card)
    launches = dict(LAUNCHES)
    fresh = [g for k, g in seen.items() if k not in since]
    want = graph_launches(seen, since)
    for g in fresh:
        for k, n in g.per_replay.items():
            want[k] += n
    per_pool = {lid: graph_launches(seen, since,
                                    lambda key, lid=lid: key[0] == lid)
                for lid in sorted({k[0] for k in seen})}
    decisions = [d["decision"] for d in list(eng.engine.decisions)[n_dec:]]
    status = eng._inspect("status")
    bad = [i for i, (r, w) in enumerate(zip(reqs, want_tok))
           if not np.array_equal(r.output(), w)]
    short = [i for i, r in enumerate(reqs) if len(r.output()) != PLACED_NEW]
    pools = [sp.lid for sp in eng.pools]
    weights = [eng._params_for(sp)[0] for sp in eng.pools]
    shared_end = all([t.data_ptr() for t in _leaves(w)] == ptrs
                     for w in weights)
    rate_a = sum(len(r.output()) for r in reqs) / wall
    log(f"[placed] a: {PLACED_REQS} requests ({PLACED_NEW} new tokens "
        f"each); pool 0 drained at tick {drained}, pool {added} joined "
        f"placed at tick {drained + 1}; {wall:.4f} s, "
        f"{sum(len(r.output()) for r in reqs) / wall:.1f} generated tok/s; "
        f"placement {status['placement']}; pools left {pools}, devices "
        f"{[p['devices'] for p in status['pools']]}; decisions "
        f"admission_pool {decisions.count('admission_pool')}, "
        f"migration_dst {decisions.count('migration_dst')}, serve_job "
        f"{decisions.count('serve_job')}; largest candidate load {load}; "
        f"{len(reqs) - len(short)} of {len(reqs)} requests complete, "
        f"{len(reqs) - len(bad)} equal to generate_static")
    log(f"[placed] a: launches {_nonzero(launches)} (replays x per replay, "
        f"and one eager warm-up step per capture in the run ({len(fresh)}): "
        f"{'equal' if launches == want else want}); by pool "
        + "; ".join(f"{lid}: {_nonzero(m)}" for lid, m in per_pool.items()))
    checks = {
        "requests differ from generate_static": bad,
        "requests incomplete": short,
        "no slot migrated": eng.migrated_slots < 1,
        f"pools left {pools}, not [1, 2]": pools != [1, 2],
        f"placed pools {status['placement']['placed_pools']}, not 2":
            status["placement"]["placed_pools"] != 2
            or any(p["devices"] is None for p in status["pools"]),
        "no admission_pool decision": "admission_pool" not in decisions,
        "no candidate with load > 0": not load > 0,
        "a placed pool reads a copy of the weights":
            not (shared and shared_end),
        f"memory_allocated grew {grown} B, over the rows and the plan "
        f"{rows_b + plan_b} B": grown > rows_b + plan_b,
        f"launches {launches} are not the replays' {want}": launches != want,
        "a pool's graphs launched not every MoE kernel": not all(
            m[k] for m in per_pool.values() for k in MOE_KERNELS),
    }
    # the MoE kernels on the joined placed pool's rows, through its weights
    copy = SlotPool(cfg, POOL_SLOTS, SERVE_MAX_LEN, dev)
    sp = eng._pool(added)
    sp.gather_into(copy, torch.arange(POOL_SLOTS, device=dev))
    rows, shapes = check_kernels(
        torch, step_inputs(torch, cfg, eng._params_for(sp)[0], dev, rng,
                           copy), per_pool.get(added, want))
    log_kernel_rows(suffixed(rows, "placed"), shapes)
    del eng, psrv, copy, sp, seen, weights
    _free(torch)
    # b. the two pools given distinct device-group keys on the one card: a
    # stand-in for two cards (the group path's plan, dispatch of every
    # tick, then each tick's one host copy) whose overlap it cannot show
    psrv = pool_server(cfg, srv, dev, placements=placements)
    eng = psrv.engine()
    for p in eng.pools:
        p.devices = lambda lid=p.lid: (f"{card}, group {lid}",)
    reqs, wall_b, _, _, _, _ = placed_run(torch, eng, psrv.submit, prompts)
    bad_b = [i for i, (r, w) in enumerate(zip(reqs, want_tok))
             if not np.array_equal(r.output(), w)]
    log(f"[placed] b: the 2 pools under distinct device-group keys on the "
        f"one card (a same-card stand-in for two cards; the overlap is not "
        f"measured): {eng.tick_no} ticks, parallel_group_ticks "
        f"{eng.parallel_group_ticks}, {wall_b:.4f} s, "
        f"{sum(len(r.output()) for r in reqs) / wall_b:.1f} generated "
        f"tok/s (graphs captured in the run); "
        f"{len(reqs) - len(bad_b)} of {len(reqs)} equal to generate_static")
    checks["b: no parallel group tick"] = eng.parallel_group_ticks < 1
    checks["b: requests differ from generate_static"] = bad_b
    del eng, psrv
    _free(torch)
    secs = time.perf_counter() - t_phase
    log(f"[placed] phase {secs:.1f} s (budget {PLACED_BUDGET_S} s)")
    for what, bad_ in checks.items():
        if bad_:
            fails.append(f"placed: {what}" + (f": {bad_[:5]}"
                                              if isinstance(bad_, list)
                                              else ""))
    return rows, rate_a


# [mesh]: pools over a device group that names the card twice, on the
# [pools] server's model and [placed]'s prompts: a. a 4-slot pool split
# over it (2 rows a shard), a 2-slot pool's slots migrating into it and
# its slots out into another 2-slot pool (every tick 2 rows high, so every
# request is held to a 2-row oracle: cuBLAS rounds rows by the product's
# height); b. a 4-slot pool at pool_tp 2 (rows split by heads, the
# tensor-parallel step a graph per TP shard and stage, the copies between
# them outside: engine.serve.StagedStep), held to [pools]' 4-row oracle
# under the near-tie rule; c. the same form on a dense model
MESH_BUDGET_S = 40.0            # a and b
MESH_STEPS = 8                  # TP vs unsplit: steps along one state
# the TP step's logits against the unsplit step's, atol and rtol (tests/
# test_torch_serve.py's TOL: the split products add their partial sums in
# another order), whole in b, layer by layer in b and c; a token parts from
# the oracle at a near-tie only where its top-2 margin is within what this
# bound lets the two logits move
MESH_TP_TOL = 2e-2
# c. starcoder2-7b (arXiv:2402.19173) at its published widths and depth
# (d_model 4608, 36 heads over 4 KV heads, d_ff 18432, vocab 49152, 32
# layers): a dense GQA split at a width where tensor parallelism is used;
# 2 slots, 2 prompts, held to its own 2-row static loop
MESH_C_ARCH = "starcoder2-7b"
# c's whole TP step against the unsplit step, in units of the MESH_TP_TOL
# bound: 32 random bf16 layers carry a layer's last-bit rounding past
# that bound, as the unsplit step shows against itself at twice the rows
# (up to 2.7154 of it on an H100 at 700 W, where the TP step read up to
# 3.9898; PERF.md section 6); the limit is twice that height reading
MESH_C_STEP_LIMIT = 5.4308
MESH_C_SLOTS, MESH_C_LENS, MESH_C_NEW = 2, (24, 40), 16
MESH_C_MAX_LEN = 96
MESH_C_BUDGET_S = 60.0


def requested_bytes(torch) -> int:
    """Bytes the live tensors on the card asked the caching allocator for,
    before its rounding and its unsplit block remainders."""
    return torch.cuda.memory_stats()["requested_bytes.all.current"]


def shard_graphs(graphs, since, lid) -> dict:
    """Per shard of pool ``lid``: its graphs' (captures, replays since
    ``since``) and per-replay launches."""
    out = {}
    for key, g in graphs.items():
        if key[0] == lid and len(key) == 4:
            out.setdefault(key[3], []).append(
                (key[2], g.replays - since.get(key, 0),
                 _nonzero(g.per_replay)))
    return out


def mesh_run(torch, eng, submit, prompts, card) -> tuple:
    """Serve ``prompts`` on ``eng`` (pool 0 split, pool 1 a 2-slot pool on
    ``card``): the first two pinned to pool 1, which drains into the split
    pool once one has a token; once pool 1 has retired, the rest; once a
    request on the split pool's second shard has ticked, a 2-slot pool
    joins on ``card`` and pool 0 drains into it.  Returns
    (requests, wall, every graph held, the migrations as (src lid, dst
    lid, slots))."""
    moves, mig = [], eng._migrate_slots

    def logged(src, dst, mv):
        moves.append((src.lid, dst.lid, len(mv)))
        return mig(src, dst, mv)

    eng._migrate_slots = logged
    seen = dict(eng._tick.graphs)
    stage = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [submit(p, PLACED_NEW, pool=1) for p in prompts[:2]]
    for _ in range(20_000):
        if len(reqs) == len(prompts) and all(r.done.is_set() for r in reqs):
            break
        if stage == 0 and any(r.tokens for r in reqs):
            eng.drain_pool(1)
            stage = 1
        elif stage == 1 and eng._pool(1) is None:
            reqs += [submit(p, PLACED_NEW) for p in prompts[2:]]
            stage = 2
        elif stage == 2 and any(r.prompt_off for r in reqs
                                if r.pool == 0 and r.slot >= 2):
            # the split pool's second shard has ticked: its in-flight
            # slots move out at the next tick's top
            eng.add_pool(placement=card, slots=2)
            eng.drain_pool(0)
            stage = 3
        assert eng.tick()
        freeze_graphs(seen, eng._tick.graphs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng._migrate_slots = mig
    return reqs, wall, seen, moves


def over_bound(got, ref) -> float:
    """The largest |got - ref| over MESH_TP_TOL * (1 + |ref|)."""
    ref = ref.float()
    return ((got.float() - ref).abs() / (MESH_TP_TOL * (1 + ref.abs())))\
        .max().item()


def tp_layers(torch, cfg, params, shards, whole, split, tok) -> list:
    """The TP step layer by layer against the unsplit one from ``whole``'s
    state (a one-device pool; ``split``, a pool of the TP layout, gets its
    rows): each step's own loop, eagerly (``lm.decode_step`` and
    ``models.tp.decode_step``), with a ``tap`` that keeps each unsplit
    layer's output and hands it to the TP step as its next layer's input.
    The embedding's, every block's and the head's largest difference over
    the bound (``over_bound``); both pools are left with ``whole``'s
    rows."""
    from repro_torch.models import lm, tp
    slots = range(whole.slots)
    now = whole.read_rows(slots, pos=True)
    split.write_rows(slots, now)
    ref, out = [], []

    def keep(i, x):
        ref.append(x.clone())
        return x

    def swap(i, x):
        out.append(over_bound(x, ref[i]))
        return ref[i]

    t = tok[:, None]
    a = lm.decode_step(params, {"caches": whole.caches, "pos": whole.pos}, t,
                       cfg, moe_groups="row", tap=keep)[0]
    b = tp.decode_step(shards, {"caches": split.caches, "pos": split.pos}, t,
                       cfg, split.group, moe_groups="row", tap=swap)[0]
    out.append(over_bound(b, a))
    for pool in (whole, split):
        pool.write_rows(slots, now)
    return out


def tp_against_unsplit(torch, cfg, eng, sp, dev, rng) -> dict:
    """The TP pool's rows copied into a one-device pool (``whole``) and
    into three pools of the TP layout, stepped MESH_STEPS times on the
    unsplit step's greedy tokens, ``whole`` through a ``GraphedStep`` and
    two TP pools through ``StagedStep``s of their own, the graphs a tick
    runs.  ``same`` and ``eager`` get ``whole``'s rows before each step,
    so each of their steps starts from the unsplit step's state:
    ``ratios``, each step's largest logit difference over the bound
    MESH_TP_TOL * (1 + |unsplit logit|); ``equal``, whether ``same``'s
    stage graphs gave the logits and argmax of the same step run eagerly
    on ``eager`` (``build_decode_step``'s step over the eager
    ``tp.Stages``), bit for bit.  ``own`` steps along its own state, as a
    served pool does, so its rounding compounds through the cache:
    ``drift``, its largest logit difference.  ``height``: the ratio of the
    unsplit step itself run at twice the rows (each row twice) from the
    same state, against ``whole``'s: what rounding alone (cuBLAS rounds
    rows by the product's height) moves the logits by.  ``layers``: at the
    first and the last step, ``tp_layers``' ratios.  ``ms``: a step's time
    by replay between events, each called as a tick calls it: the
    ``StagedStep`` (its stage graphs and the copies between them, launched
    from the host), the TP step captured whole in one ``GraphedStep`` on
    this card (the form a TP pool ran before it was staged) and the
    unsplit ``GraphedStep``.  ``ints``, for a MoE model, the TP MoE
    layer's integers against the unsplit layer's on one input;
    ``counts``, the step's stages per shard."""
    from repro_torch.engine.serve import (GraphedStep, SlotPool, SlotTick,
                                          StagedStep)
    from repro_torch.models import lm, tp
    from repro_torch.models import moe as moe_lib
    n = sp.slots
    slots = range(n)
    rows = sp.read_rows(slots, pos=True)
    whole = SlotPool(cfg, n, sp.max_len, dev, lid=100)
    same, own, eager = (SlotPool(cfg, n, sp.max_len, None, mesh=sp.mesh,
                                 lid=lid) for lid in (101, 102, 104))
    twice = SlotPool(cfg, 2 * n, sp.max_len, dev, lid=103)
    for pool in (whole, same, own):
        pool.write_rows(slots, rows)
    tick = SlotTick(cfg, dev, graph=True)
    params, shards = eng.params, eng._params_for(sp)[0]
    runs = [tick.runner("step", w, None, pool)
            for w, pool in ((params, whole), (shards, same), (shards, own),
                            (params, twice))]
    if not all(isinstance(r, StagedStep) for r in runs[1:3]):
        raise AssertionError("a TP pool's step is not a StagedStep")
    step = tick.steps["step"]
    active = torch.ones(n, dtype=torch.bool, device=dev)
    out = {"ratios": [], "height": [], "drift": 0.0, "layers": [],
           "equal": []}
    with torch.no_grad():
        tok = torch.as_tensor(rng.integers(1, cfg.vocab, n), device=dev)
        for i in range(MESH_STEPS):
            now = whole.read_rows(slots, pos=True)
            same.write_rows(slots, now)
            twice.write_rows(range(2 * n), {
                k: torch.cat([v, v], 0 if k[0] in ("ng", "ctx", "pos")
                             else 1) for k, v in now.items()})
            if i in (0, MESH_STEPS - 1):
                out["layers"].append(tp_layers(torch, cfg, params, shards,
                                               whole, eager, tok))
            else:
                eager.write_rows(slots, now)
            a, greedy = (t.clone() for t in runs[0](tok, active))
            b, bg = (t.clone() for t in runs[1](tok, active))
            e, eg = step(shards, None, eager, tok, active)
            out["equal"].append(bool(torch.equal(b, e))
                                and bool(torch.equal(bg, eg)))
            c = runs[2](tok, active)[0]
            out["ratios"].append(over_bound(b, a))
            out["drift"] = max(out["drift"],
                               (a.float() - c.float()).abs().max().item())
            d = runs[3](torch.cat([tok, tok]), torch.cat([active, active]))
            out["height"].append(over_bound(d[0][:n], a))
            tok = greedy
        one = GraphedStep(step, shards, None, same)
        out["ms"] = {"tp": event_ms(torch, lambda: runs[1](tok, active)),
                     "tp one graph": event_ms(torch,
                                              lambda: one(tok, active)),
                     "unsplit": event_ms(torch, lambda: runs[0](tok, active))}
        del one
        out["ints"] = None
        if cfg.moe is not None:
            # the MoE layer alone on one input: routing, dispatch and
            # combine run once, so its integers are the unsplit layer's
            x = torch.randn((n, 1, cfg.d_model), device=dev,
                            dtype=torch.bfloat16)
            plan = moe_lib.identity_plan(cfg, 1, device=dev)
            off = torch.arange(n, device=dev)
            _, m1 = moe_lib.moe_ffn(lm._layer_views(params, "moe", 1)[0], x,
                                    plan.slots[0], plan.cum[0], cfg, off)
            ps = [lm._layer_views(s_, "moe", 1)[0] for s_ in shards]
            _, m2 = tp.moe_ffn(ps, x, plan.slots[0], plan.cum[0], cfg, off,
                               sp.group)
            out["ints"] = {k: bool(torch.equal(m1[k], m2[k]))
                           for k in ("slot_counts", "kept_counts", "dropped",
                                     "expert_counts")}
    out["counts"] = runs[1].stage_counts()
    del runs, tick
    return out


def stage_report(tick, since) -> tuple:
    """The stage graphs of ``tick``'s TP steps (``SlotTick.stage_graphs``,
    keyed by (pool, step, rows, data shard, TP shard, stage)) per TP
    shard: their count, their replays since ``since`` (a snapshot of
    ``stage_graphs()``'s replays; a step captured since adds its warm-up
    step once a stage) and their kernel nodes a replay; each TP step's
    copies a step; the MoE kernel launches those replays made, read from each
    stage graph's kernel nodes; and the breaches: a stage graph whose MoE
    kernel nodes are not its capture's counts, or a MoE kernel node in a
    stage of a shard other than the first (routing, dispatch and combine
    run on shard 0)."""
    from repro_torch.engine.serve import StagedStep
    from repro_torch.kernels.graphs import graph_nodes
    shards, want, bad = {}, dict.fromkeys(MOE_KERNELS, 0), []
    marks = {"moe_gating": "gating_kernel",
             "moe_dispatch": "dispatch_scatter",
             "moe_combine": "combine_kernel"}
    for key, st in tick.stage_graphs().items():
        was = since.get(key)
        n = st.replays - was if was is not None else st.replays + 1
        nodes = [nm for kind, nm in graph_nodes(st.graph) if kind == "kernel"]
        got = {k: sum(m in nm for nm in nodes) for k, m in marks.items()}
        ent = shards.setdefault(key[4], {"graphs": 0, "replays": 0,
                                         "kernel nodes": 0})
        ent["graphs"] += 1
        ent["replays"] += n
        ent["kernel nodes"] += len(nodes)
        for k in MOE_KERNELS:
            want[k] += n * got[k]
        if any(got[k] != st.per_replay[k] for k in MOE_KERNELS):
            bad.append(f"{key} holds MoE kernel nodes {got}, its capture "
                       f"counted {_nonzero(st.per_replay)}")
        if key[4] and any(got.values()):
            bad.append(f"{key} holds MoE kernel nodes {got}")
    copies = [g.copies for g in tick.graphs.values()
              if isinstance(g, StagedStep)]
    return shards, copies, want, bad


def mesh_tp(torch, dev, tag, cfg, params, group, slots, max_len, prompts,
            new, ref, top2, fails, moe, limit) -> tuple:
    """A ``slots``-slot pool at ``pool_tp = 2`` over ``group`` serving
    ``prompts`` (``new`` tokens each) through ``BatchedServer`` →
    ``ServeEngine`` → the stage graphs of ``models.tp``'s step, on
    ``params`` (the engine's weights; each shard's slices made by
    ``tp.split_params``).  ``ref(prompt)`` gives the static loop's
    tokens, ``top2(prompt)`` its top-2 logits a step (the near-tie rule's
    room, asked only of a request that parts from it).  Logs the
    weight bytes per shard, the stage and graph counts per shard, the
    launches (from the stage graphs' kernel nodes), tok/s, the logits
    against the unsplit step's and the step times; with ``moe``, holds
    kernels 1-3 against their plain versions on the TP pool's rows and
    returns their JSON rows.  Holds (``tp_against_unsplit``) the stage
    graphs' logits and argmax to the eager step's bit for bit, each TP
    layer to the unsplit layer within MESH_TP_TOL and the whole step's
    logits to the unsplit step's within ``limit`` times that bound.
    Returns (rows, checks)."""
    import dataclasses as dc
    from repro_torch.engine.serve import SlotPool
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.runtime.serve import BatchedServer
    rng = np.random.default_rng(SEED + 11)
    tcfg = dc.replace(cfg, serve=dc.replace(cfg.serve, pool_tp=2))
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    tsrv = BatchedServer(tcfg, params, max_len=max_len, slots=slots,
                         compact_decode=False, placements={0: group},
                         device=dev)
    eng = tsrv.engine()
    sp = eng.pools[0]
    split = eng._params_for(sp)[0]
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    shard_b = [sum(t.numel() * t.element_size() for t in _leaves(w))
               for w in split]
    t0 = time.perf_counter()
    warm_pools(torch, eng, cfg, rng)
    warm = time.perf_counter() - t0
    since = {k: st.replays for k, st in eng._tick.stage_graphs().items()}
    replays0 = {k: g.replays for k, g in eng._tick.graphs.items()}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [tsrv.submit(p, new) for p in prompts]
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in MOE_KERNELS}
    shards, copies, want, bad_nodes = stage_report(eng._tick, since)
    steps = {k[2]: g.replays - replays0.get(k, 0)
             for k, g in eng._tick.graphs.items() if k[1] == "step"}
    rate = sum(len(r.output()) for r in reqs) / wall
    cmp = tp_against_unsplit(torch, cfg, eng, sp, dev, rng)
    ratios, ms, ints = cmp["ratios"], cmp["ms"], cmp["ints"]
    ratio = max(ratios)
    layer = max(max(x) for x in cmp["layers"])
    near = []
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        want_t = ref(p)
        if not np.array_equal(r.output(), want_t):
            # the gate lets each of the top-2 logits move by MESH_TP_TOL
            # * (1 + |logit|), so a flip needs a margin within their sum
            t2 = top2(p)
            allow = MESH_TP_TOL * (2 + np.abs(t2).sum(-1))
            near += [(i,) + x[1:] for x in near_tie_check(
                f"{tag}, request {i}", r.output()[None], want_t[None],
                (t2[:, 0] - t2[:, 1])[None], allow[None], fails)]
    engine_b = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"{tag}: a {slots}-slot pool at pool_tp 2 over "
        f"{[str(d) for d in group]}: each shard's weights {shard_b} B (the "
        f"engine's {engine_b} B; memory_allocated grew {grown} B with the "
        f"shards' weights and the pool's rows); the pool's first serve "
        f"(its captures) {warm:.2f} s; {len(prompts)} requests "
        f"({new} new tokens each) in {wall:.4f} s, {rate:.1f} generated "
        f"tok/s; TP steps by height (replays) {steps}")
    log(f"{tag}: stage graphs per TP shard of the served StagedSteps "
        f"(graphs, replays in the run, kernel nodes a replay) {shards}; "
        f"a step's stages per shard {cmp['counts']}, exchanges' copies a "
        f"step "
        f"{copies}; no stage graph holds two shards' work (each is "
        f"captured between two stage switches on its shard's device)")
    log(f"{tag}: the TP step's logits from the unsplit step's state, the "
        f"largest difference over its bound (atol = rtol = {MESH_TP_TOL}) "
        f"at each of {MESH_STEPS} steps {[round(x, 4) for x in ratios]} "
        f"(limit {limit}; the unsplit step at {2 * slots} rows, each row "
        f"twice, against itself at {slots}: "
        f"{[round(x, 4) for x in cmp['height']]}); the stage graphs' "
        f"logits and argmax equal to the eager staged step's bit for bit "
        f"at each step: {cmp['equal']}; along the TP pool's own state the "
        f"largest logit difference {cmp['drift']:.6f}; a step at {slots} "
        f"rows by replay between events: the StagedStep {ms['tp']:.4f} ms, "
        f"the TP step as one graph on this card {ms['tp one graph']:.4f} "
        f"ms ({ms['tp'] / ms['tp one graph']:.3f}x), the unsplit "
        f"GraphedStep {ms['unsplit']:.4f} ms "
        f"({ms['tp'] / ms['unsplit']:.3f}x); (request, token, margin) "
        f"parting from the {slots}-row generate_static at a near-tie "
        f"within the bound's room for the top-2 logits: {near}")
    log(f"{tag}: layer by layer from the unsplit layer's input (embedding, "
        f"{cfg.num_layers} blocks, head), the largest difference over the "
        f"bound at the first and the last step: "
        f"{[[round(x, 4) for x in r] for r in cmp['layers']]}")
    if moe:
        log(f"{tag}: the MoE layer's integers equal the unsplit layer's: "
            f"{ints}; launches {_nonzero(launches)} (the stage graphs' "
            f"replays x their MoE kernel nodes, and one warm-up step per "
            f"capture in the run: "
            f"{'equal' if launches == want else want})")
    checks = {
        f"launches {launches} are not the stage graphs' {want}":
            launches != want,
        "a stage graph's kernel nodes": bad_nodes,
        "the pool is not at tp 2": sp.tp != 2,
        "a shard ran no stage graph": sorted(shards) != [0, 1],
        "the stage graphs' logits or argmax differ from the eager staged "
        f"step's at a step: {cmp['equal']}": not all(cmp["equal"]),
        f"a TP layer's output parts from the unsplit layer's by "
        f"{layer:.4f} of atol = rtol = {MESH_TP_TOL}": not layer <= 1,
        f"the TP step's logits part from the unsplit step's by "
        f"{ratio:.4f} of atol = rtol = {MESH_TP_TOL}, over {limit}":
            not ratio <= limit,
    }
    rows = []
    if moe:
        checks.update({
            "the TP MoE layer's integers differ": not all(ints.values()),
            "no MoE kernel launched from shard 0's stage graphs":
                min(want.values()) == 0})
        # the MoE kernels on the TP pool's rows, through its shards'
        # weights
        copy = SlotPool(cfg, slots, max_len, None, mesh=sp.mesh)
        sp.gather_into(copy, range(slots))
        rows, shapes = check_kernels(
            torch, step_inputs(torch, cfg, split, dev, rng, copy), want)
        log_kernel_rows(suffixed(rows, "tp"), shapes)
        del copy
    del eng, tsrv, sp, split
    _free(torch)
    return rows, checks


def mesh_dense(torch, dev, group, fails) -> dict:
    """[mesh] c: MESH_C_ARCH at its published widths (bf16 weights drawn
    on the card from SEED) in a MESH_C_SLOTS-slot pool at ``pool_tp = 2``
    over ``group``, held to its own MESH_C_SLOTS-row static loop under the
    near-tie rule (``mesh_tp``).  Returns the checks."""
    from repro_torch.configs import get_arch
    from repro_torch.runtime.serve import BatchedServer
    cfg = get_arch(MESH_C_ARCH)
    log(f"[mesh] c: {cfg.name}, {cfg.num_layers} layers")
    params = model_init(torch, cfg, dev, "mesh c")
    srv = BatchedServer(cfg, params, max_len=MESH_C_MAX_LEN, device=dev)
    oracle = StaticOracle(torch, srv, fails, rows=MESH_C_SLOTS,
                          tag="mesh c")
    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in MESH_C_LENS]
    oracle.prefetch([(p, MESH_C_NEW) for p in prompts])

    _, checks = mesh_tp(
        torch, dev, "[mesh] c", cfg, srv.params, group, MESH_C_SLOTS,
        MESH_C_MAX_LEN, prompts, MESH_C_NEW,
        lambda p: oracle(p, MESH_C_NEW),
        lambda p: oracle.margins(p, MESH_C_NEW, top2=True)[1], fails,
        moe=False, limit=MESH_C_STEP_LIMIT)
    del srv, oracle, params
    _free(torch)
    return checks


def mesh_phase(torch, dev, cfg, srv, oracle, prompts, placed_rate,
               fails) -> list:
    """Pools over a device group on the card: see the module docstring's
    [mesh].  Returns the MoE kernels' JSON rows on the TP pool's rows."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.runtime.serve import BatchedServer
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    prompts = prompts[:PLACED_REQS]
    card = torch.device(dev.type, 0)
    group = [card, card]
    checks = {}
    # a. the split pool: its weights are the engine's, its rows all it adds
    osrv = BatchedServer(oracle_cfg(cfg, 2, 2), srv.params,
                         max_len=SERVE_MAX_LEN, device=dev)
    oracle2 = StaticOracle(torch, osrv, fails, rows=2, tag="mesh")
    oracle2.prefetch([(p, PLACED_NEW) for p in prompts])
    torch.cuda.synchronize()
    mem0, req0 = torch.cuda.memory_allocated(), requested_bytes(torch)
    msrv = BatchedServer(cfg, srv.params, max_len=SERVE_MAX_LEN,
                         slots=POOL_SLOTS, compact_decode=False,
                         placements={0: group}, device=dev)
    eng = msrv.engine()
    sp = eng.pools[0]
    weights = [eng._params_for(sh)[0] for sh in sp.shards]
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    # the bytes the new tensors asked for, held exactly: the allocator may
    # hand a tensor a whole free block whose remainder is too small to
    # split, which memory_allocated counts and this does not
    grown_req = requested_bytes(torch) - req0
    row_t = [t for sh in sp.shards
             for t in [c for _, c, _ in sh.row_leaves()] + [sh.pos]]
    rows_b = sum(t.numel() * t.element_size() for t in row_t)
    plan = moe_lib.identity_plan(cfg, lm.n_moe_layers(cfg), device="meta")
    plan_b = sum(t.numel() * t.element_size()
                 for t in (plan.slots, plan.cum))
    ptrs = [t.data_ptr() for t in _leaves(eng.params)]
    shared = all([t.data_ptr() for t in _leaves(w)] == ptrs for w in weights)
    lay = eng._inspect("status")["pools"][0]["layout"]
    log(f"[mesh] a: a {POOL_SLOTS}-slot pool over {[str(d) for d in group]}"
        f", layout {lay}; the live tensors' requested bytes grew "
        f"{grown_req} B over the engine's construction and its shards' "
        f"weights (the shards' rows {rows_b} B, the tick's routing plan "
        f"{plan_b} B; memory_allocated grew {grown} B; the weights "
        f"{sum(t.numel() * t.element_size() for t in _leaves(eng.params))}"
        f" B); the shards read the engine's weight tensors: {shared}")
    eng.add_pool(placement=card, slots=2)
    warm = warm_pools(torch, eng, cfg, rng)
    since = {k: g.replays for k, g in eng._tick.graphs.items()}
    reset_launches()
    reqs, wall, seen, moves = mesh_run(torch, eng, msrv.submit, prompts,
                                       card)
    launches = dict(LAUNCHES)
    fresh = [g for k, g in seen.items() if k not in since]
    want = graph_launches(seen, since)
    for g in fresh:
        for k, n in g.per_replay.items():
            want[k] += n
    bad = [i for i, (p, r) in enumerate(zip(prompts, reqs))
           if not np.array_equal(r.output(), oracle2(p, PLACED_NEW))]
    rate = sum(len(r.output()) for r in reqs) / wall
    shards = shard_graphs(seen, since, 0)
    log(f"[mesh] a: {PLACED_REQS} requests ({PLACED_NEW} new tokens each); "
        f"warm-up serves {[round(w[0], 4) for w in warm]} s; migrations "
        f"(src, dst, slots) {moves}; {wall:.4f} s, {rate:.1f} generated "
        f"tok/s ([placed] a: {placed_rate:.1f}); {len(reqs) - len(bad)} of "
        f"{len(reqs)} equal to the 2-row generate_static ({oracle2.seconds:.1f}"
        f" s); per shard of pool 0 (rows, replays, per replay) {shards}")
    log(f"[mesh] a: launches {_nonzero(launches)} (replays x per replay, "
        f"and one warm-up step per capture in the run ({len(fresh)}): "
        f"{'equal' if launches == want else want})")
    checks.update({
        "a: requests differ from the 2-row generate_static": bad,
        "a: the pool is not split 2 + 2": lay["rows"] != "split"
            or [sh.slots for sh in sp.shards] != [2, 2],
        "a: no slot migrated into the split pool": not any(
            d == 0 for _, d, _ in moves),
        "a: no slot migrated out of the split pool": not any(
            s_ == 0 for s_, _, _ in moves),
        "a: a shard reads a copy of the weights": not shared,
        f"a: the requested bytes grew {grown_req} B, over the rows and the "
        f"plan {rows_b + plan_b} B": grown_req > rows_b + plan_b,
        f"a: launches {launches} are not the replays' {want}":
            launches != want,
        "a: a shard ran no graph": sorted(shards) != [0, 1],
    })
    del eng, msrv, sp, seen, weights
    _free(torch)
    # b. pool_tp = 2 over the same group: the TP step's stage graphs
    oracle.prefetch([(p, MIGRATE_NEW) for p in prompts])

    def top2_b(p):
        return oracle.margins(p, MIGRATE_NEW, top2=True)[1][:PLACED_NEW]

    rows, checks_b = mesh_tp(
        torch, dev, "[mesh] b", cfg, srv.params, group, POOL_SLOTS,
        SERVE_MAX_LEN, prompts, PLACED_NEW,
        lambda p: oracle(p, MIGRATE_NEW)[:PLACED_NEW], top2_b, fails,
        moe=True, limit=1.0)
    checks.update({f"b: {k}": v for k, v in checks_b.items()})
    secs_b = time.perf_counter() - t_phase
    # c. starcoder2-7b at its published widths, a dense GQA split
    t_c = time.perf_counter()
    checks.update({f"c: {k}": v
                   for k, v in mesh_dense(torch, dev, group, fails).items()})
    secs_c = time.perf_counter() - t_c
    log(f"[mesh] a and b {secs_b:.1f} s (budget {MESH_BUDGET_S} s), c "
        f"{secs_c:.1f} s (budget {MESH_C_BUDGET_S} s)")
    for what, bad_ in checks.items():
        if bad_:
            fails.append(f"mesh: {what}" + (f": {bad_[:5]}"
                                            if isinstance(bad_, list)
                                            else ""))
    return rows


def serve_features_phase(torch, dev, fails, phase_time) -> list:
    """[spec], [prefix], [publish], [pools], [compact], [autotune],
    [migrate] and [placed] on one full-width model.  Returns the kernels'
    JSON rows of [pools], [compact], [migrate] and [placed]."""
    from repro_torch.models import lm
    from repro_torch.runtime.serve import BatchedServer
    cfg = moe_cfg()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)
    srv = BatchedServer(cfg, params, max_len=SERVE_MAX_LEN,
                        slots=SERVE_SLOTS, device=dev)
    del params
    oracle = StaticOracle(torch, srv, fails)
    spec_phase(torch, dev, cfg, srv, oracle, fails)
    prefix_phase(torch, dev, cfg, srv, fails)
    publish_phase(torch, dev, cfg, srv, fails)
    phase_time("spec, prefix, publish")
    rows = pools_phase(torch, dev, cfg, srv, oracle, fails)
    phase_time("pools")
    compact_rows, allow = compact_phase(torch, dev, cfg, srv, fails)
    rows += compact_rows
    phase_time("compact")
    autotune_phase(torch, dev, cfg, srv, oracle, allow, fails)
    phase_time("autotune")
    migrate_rows, prompts = migrate_phase(torch, dev, cfg, srv, oracle,
                                          fails)
    rows += migrate_rows
    phase_time("migrate")
    placed_rows, placed_rate = placed_phase(torch, dev, cfg, srv, oracle,
                                            prompts, fails)
    rows += placed_rows
    phase_time("placed")
    rows += mesh_phase(torch, dev, cfg, srv, oracle, prompts, placed_rate,
                       fails)
    phase_time("mesh")
    return rows


# [train]: paper-moe-100m at full width, trained by TrainLoop with the
# fused kernels on and the Reshape loop closed (as src/repro/launch/
# train.py sets it up), on a skewed token stream
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB, TRAIN_STEPS = 1024, 8, 2, 6
TRAIN_ALPHA = 1.5
# kernels vs plain versions over one full step: loss within 1e-3 relative,
# each gradient leaf within 5e-2 relative L2 (bf16 forward and backward,
# rounded at other points by the attention kernel and cuBLAS)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-3, 5e-2
# a token that the kernel step and the all-plain step first route to
# different experts must be a near-tie of the plain router: a top-k margin
# of at most this many bf16 ulps of the token's largest |logit|
FLIP_MARGIN_ULPS = 4

# [flash]: (tag, [B, S, H, hd] in the model's layout, window), bf16,
# causal: the training shape, zamba2-7b's shared attention, a ragged length
# and gemma3-1b's local attention at head dim 256 (its window of 1024 over
# 1100 rows, so the window masks)
FLASH_CASES = (("train", (4, 1024, 8, 64), None),
               ("zamba2", (2, 1024, 32, 112), None),
               ("ragged", (4, 1000, 8, 64), None),
               ("hd256", (2, 1100, 4, 256), 1024),
               # engine.draft.distill_draft's forward on small_draft_cfg
               # (d_model 32, 2 heads of 16; its batch 16 of 24 tokens)
               ("draft", (16, 24, 2, 16), None))
# the cases timed beside the library, forward (and backward where named)
FLASH_TIMED = {"train": True, "zamba2": False, "draft": True}
# kernel vs plain version (both bf16, each rounding its results at other
# points and after sums in another order), by relative L2 error: over the
# whole tensor within FLASH_RTOL, and within FLASH_TILE_RTOL in every tile
# of FLASH_TILE sequence rows of one head (query rows for o and dq, key
# rows for dk and dv), so that a fault confined to late rows or late KV
# tiles, where the values are small, shows.  Where the plain version is
# itself farther from the f32 oracle than the kernel (its bf16 P takes
# P's gradient through a plain cast, as the reference's does, so each
# row's rounding residue reaches the running max and lands on the row's
# argmax key: dK on a model's inputs), the kernel is held to the oracle
# by the same bounds instead.
FLASH_RTOL, FLASH_TILE_RTOL, FLASH_TILE = 5e-3, 1e-2, 64


def event_ms(torch, fn, reps: int = 10) -> float:
    """Device time of one ``fn()`` call between two events, best of three
    runs of ``reps`` calls after a warm-up (for work that a CUDA graph
    cannot capture, such as autograd's backward)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def flash_work(b, s, h, hd, es, backward, window=None, sk=None,
               causal=True):
    """Attention of [B, S, H, hd] queries over ``sk`` (default S) keys and
    values, inputs of ``es`` bytes, causal (over a sliding ``window`` when
    one is given) or not: (bytes, operations).  Operations: 2·hd per
    visible (q, k) pair a product, 2 products in the forward (QK^T, PV) and
    5 in the backward (QK^T, dO·V^T, P^T·dO, dS^T·Q, dS·K); bytes: q, k, v,
    o (and dO, dq, dk, dv) once, and the f32 log-sum-exp."""
    sk = s if sk is None else sk
    if causal:
        w = s if window is None else min(window, s)
        # row i sees min(i + 1, w) keys
        pairs = b * h * (w * (w + 1) // 2 + (s - w) * w)
    else:
        pairs = b * h * s * sk
    n_q, n_k = (4, 4) if backward else (2, 2)
    return ((n_q * s + n_k * sk) * b * h * hd * es + 4 * b * h * s,
            (10 if backward else 4) * hd * pairs)


def flash_bound(b, s, h, hd, es, backward, window=None, sk=None,
                causal=True):
    """(bound ms, by) of ``flash_work`` at the bf16 tensor-core rate."""
    return bound_ms(*flash_work(b, s, h, hd, es, backward, window, sk,
                                causal), BF16_FLOP_PER_S)


def sdpa_backward(torch, q, k, v, do, causal=True):
    """One call of aten's flash-attention backward (the backward of
    ``scaled_dot_product_attention``'s flash backend) on heads-first
    inputs, as a closure that a CUDA graph can capture."""
    aten = torch.ops.aten
    o, lse, cq, ck, mq, mk, seed, offset = \
        aten._scaled_dot_product_flash_attention(q, k, v, 0.0, causal)[:8]
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, causal, seed, offset)


def flash_check(torch, tag, case, q, k, v, do, window=None, causal=True):
    """The flash kernels on q [B, Sq, H, hd], k, v [B, Sk, H, hd] bf16
    (causal, over ``window`` when one is given, or not) and dO, forward and
    backward, against
    their plain version (chunked attention in bf16, differentiated by
    autograd), with an f32 materialised oracle beside both: o, dq, dk and
    dv within FLASH_RTOL relative L2 and FLASH_TILE_RTOL in every tile of
    the plain version, or of the oracle where the plain version is farther
    from it than the kernel; and the forward's f32 o rounding to its o bit
    for bit.  Raises on a mismatch; returns (o, the f32 o, lse, {output:
    max abs error}, the plain output, the plain version's inputs) for
    timing."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_bwd_cuda, flash_fwd_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.attention import chunked_attention
    o, lse, o32 = flash_fwd_cuda(q, k, v, causal, window, keep_f32=True)
    grads = flash_bwd_cuda(q, k, v, o32, lse, do, causal, window)
    if not torch.equal(o32.to(o.dtype), o):
        raise AssertionError(f"{tag} flash {case}: the f32 o does not round "
                             f"to o")
    ps = [x.clone().requires_grad_(True) for x in (q, k, v)]
    po = chunked_attention(*ps, causal=causal, window=window)
    pgrads = torch.autograd.grad(po, ps, do, retain_graph=True)
    fs = [x.float().requires_grad_(True) for x in (q, k, v)]
    fo = attention_ref(*(x.transpose(1, 2) for x in fs), causal=causal,
                       window=window).transpose(1, 2)
    fgrads = torch.autograd.grad(fo, fs, do.float())
    torch.cuda.synchronize()
    errs, out = {}, []
    for name, got, plain, oracle in zip(
            ("o", "dq", "dk", "dv"), (o,) + grads, (po,) + pgrads,
            (fo,) + fgrads):
        errs[name] = (got.float() - plain.float()).abs().max().item()
        rel = _rel_l2(torch, got, plain)
        tile = _tile_rel_l2(torch, got, plain)
        k_rel, p_rel = (_rel_l2(torch, x, oracle) for x in (got, plain))
        k_or, p_or = (_tile_rel_l2(torch, x, oracle) for x in (got, plain))
        held = "plain"
        if not (rel <= FLASH_RTOL and tile <= FLASH_TILE_RTOL):
            held = "f32 oracle, the plain farther from it"
            if not (k_rel < p_rel and k_rel <= FLASH_RTOL and
                    k_or <= FLASH_TILE_RTOL):
                raise AssertionError(
                    f"{tag} flash {case}: {name} kernel vs plain rel L2 "
                    f"{rel}, worst tile {tile} > {FLASH_RTOL}, "
                    f"{FLASH_TILE_RTOL}; vs the f32 oracle {k_rel}, worst "
                    f"tile {k_or} (the plain's {p_rel}, {p_or})")
        out.append(f"{name} {rel:.4g}, worst tile {tile:.4g} (vs f32: "
                   f"kernel {k_rel:.4g}, worst tile {k_or:.4g}; plain "
                   f"{p_rel:.4g}, worst tile {p_or:.4g}; max abs "
                   f"{errs[name]:.4g} of "
                   f"{plain.float().abs().max().item():.4g}; held to the "
                   f"{held})")
    log(f"[{tag}] {case} q,dO {list(q.shape)}, k,v {list(k.shape)} bf16 "
        f"{'causal' if causal else 'not causal'}, window "
        f"{window}, kernel vs plain rel L2: {'; '.join(out)}; tolerance "
        f"{FLASH_RTOL}, {FLASH_TILE_RTOL} in every {FLASH_TILE}-row tile of "
        f"a head")
    return o, o32, lse, errs, po, ps


def delta_residue(torch, q, k, v, do, o, window=None) -> str:
    """What the backward's delta_i = sum_j P_ij dP_ij would cost if it
    were taken as dO_i · o_i, o the bf16 output ``o`` or the output in f32
    before that rounding (P still rounded to bf16 where it meets V; the
    backward kernel sums this one): on q,
    k, v [B, S, H, hd] bf16 (causal, over ``window``) and dO, the change
    that each makes in dq and dk, as a relative L2 error of the exact
    gradients and their worst FLASH_TILE-row tile (everything in f64 on
    the card)."""
    s, hd = q.shape[1], q.shape[3]
    scale = hd ** -0.5
    qs = (q * scale).to(q.dtype).double().transpose(1, 2)   # [B, H, S, hd]
    kk, vv, g = (x.double().transpose(1, 2) for x in (k, v, do))
    pos = torch.arange(s, device=q.device)
    seen = pos[None, :] <= pos[:, None]
    if window is not None:
        seen = seen & (pos[None, :] > pos[:, None] - window)
    logits = (qs @ kk.transpose(-1, -2)).masked_fill(~seen, float("-inf"))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    o32 = (e.to(q.dtype).double() @ vv) / e.sum(-1, keepdim=True)
    dp = g @ vv.transpose(-1, -2)
    exact = (p * dp).sum(-1, keepdim=True)
    ds = p * (dp - exact)
    out = []
    for what, oo in (("the bf16 o", o.double().transpose(1, 2)),
                     ("the f32 o (the kernel's)", o32)):
        moved = p * (exact - (g * oo).sum(-1, keepdim=True))  # dS's change
        errs = []
        for name, ref, d in (
                ("dq", ds @ kk, moved @ kk),
                ("dk", ds.transpose(-1, -2) @ qs,
                 moved.transpose(-1, -2) @ qs)):
            ref, d = ref.transpose(1, 2), d.transpose(1, 2)
            errs.append(f"{name} {_rel_l2(torch, ref + d, ref):.4g} (worst "
                        f"tile {_tile_rel_l2(torch, ref + d, ref):.4g})")
        out.append(f"{what}: {', '.join(errs)}")
    return "; ".join(out)


def flash_phase(torch, dev, launches) -> list:
    """The flash-attention kernels against their plain version (chunked
    attention in bf16, differentiated by autograd) and an f32 materialised
    oracle, forward and backward, at each of FLASH_CASES; timed at the
    training shape and ``distill_draft``'s head dim 16 (forward and
    backward) and at zamba2-7b's (forward), beside
    ``scaled_dot_product_attention``.  ``launches`` are the [train] main
    path's counts.  Returns the JSON rows: flash_fwd and flash_bwd,
    flash_fwd@zamba2, whose launches the [zamba2] forward fills in, and
    flash_fwd@draft and flash_bwd@draft (no main path of the run
    launches them)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_bwd_cuda, flash_fwd_cuda)
    from repro_torch.models.attention import chunked_attention
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for tag, (b, s, h, hd), window in FLASH_CASES:
        q, k, v, do = (torch.randn((b, s, h, hd), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        _, o32, lse, errs, po, ps = flash_check(torch, "flash", tag, q, k,
                                                v, do, window)
        if tag in FLASH_TIMED:
            qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                               for x in (q, k, v, do))
            with torch.no_grad():
                # as its main path calls it: training keeps the f32 o
                timed = [("flash_fwd", False, errs["o"], dict(
                    ms=graph_ms(torch, lambda: flash_fwd_cuda(
                        q, k, v, keep_f32=tag == "train"), reps=10),
                    plain_ms=graph_ms(torch, lambda: chunked_attention(
                        q, k, v), reps=10),
                    library_ms=graph_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, is_causal=True), reps=10)))]
                if FLASH_TIMED[tag]:
                    timed.append(("flash_bwd", True, max(
                        errs["dq"], errs["dk"], errs["dv"]), dict(
                        ms=graph_ms(torch, lambda: flash_bwd_cuda(
                            q, k, v, o32, lse, do), reps=10),
                        library_ms=graph_ms(torch, sdpa_backward(
                            torch, qh, kh, vh, doh), reps=10))))
            if FLASH_TIMED[tag]:
                timed[1][3]["plain_ms"] = event_ms(
                    torch, lambda: torch.autograd.grad(
                        po, ps, do, retain_graph=True))
            for name, bwd, err, t in timed:
                b_ms, b_by = flash_bound(b, s, h, hd, 2, bwd)
                rows.append(dict(
                    name=name if tag == "train" else f"{name}@{tag}",
                    route="cuda",
                    source="src/repro_torch/kernels/csrc/flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention/"
                             "flash_attention.py:58",
                    launches=launches[name] if tag == "train" else 0,
                    max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                    library_ms=t["library_ms"]))
                lib = "aten flash backward" if bwd else \
                    "scaled_dot_product_attention"
                f32_o = ", writing the f32 o as training does" \
                    if tag == "train" and not bwd else ""
                log(f"[flash] {name} at {[b, s, h, hd]}{f32_o}: "
                    f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, {lib} "
                    f"{t['library_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                    f"{b_by}; all by CUDA-graph replay but the plain "
                    f"backward, timed between events)")
            if tag == "train":
                with torch.no_grad():
                    bare = graph_ms(torch, lambda: flash_fwd_cuda(q, k, v),
                                    reps=10)
                log(f"[flash] flash_fwd at {[b, s, h, hd]} without the f32 "
                    f"o (inference): {bare:.4f} ms")
            del qh, kh, vh, doh
        del q, k, v, do, o32, lse, ps, po
        _free(torch)
    return rows


# [decode_attn]: yi-34b's decode shape (rows, H, KH, max_len, hd) and the
# contexts it is timed at; caches enough to hold this many bytes cycle
# through a timed graph, so that no call finds its cache in the L2
DECODE_SHAPE = (8, 56, 8, 3088, 128)
DECODE_CTXS = (256, 1024, 3088)
DECODE_COLD_BYTES = 200e6


def decode_attn_phase(torch, dev, fails, launches) -> list:
    """The decode-attention kernel against its plain version at
    DECODE_SHAPE, first with the rows at mixed positions on and off the
    split boundaries (the test file's YI_POS), then with every row at each
    of DECODE_CTXS, timed there beside its byte bound, the plain version
    (which reads the whole cache) and ``scaled_dot_product_attention`` over
    the context.  Each check holds the kernel within the test file's
    rounding bound (``_bound``).  ``launches``: the ``[serve]`` main path's
    count.  Returns the JSON rows ``decode_attn@ctx<n>``."""
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_decode_attention import YI_POS, _bound, _worst
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.models.attention import decode_attention as plain
    b, h, kh, smax, hd = DECODE_SHAPE
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).to(
        torch.bfloat16)

    def check(k, v, pos, what):
        got = decode_attention(q, k, v, pos)
        want = plain(q, k, v, pos)
        worst = _worst(got, want, _bound(q, k, v, pos, want))
        if not worst <= 1.0:
            fails.append(f"decode_attn {what}: {worst:.3f} of the bound")
        return float((got.float() - want.float()).abs().max()), worst

    kv = [torch.randn((b, smax, kh, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    pos = torch.tensor(YI_POS, dtype=torch.long, device=dev)
    err, worst = check(*kv, pos, f"at positions {YI_POS}")
    log(f"[decode_attn] {b} rows at positions {YI_POS} of {smax}: "
        f"{worst:.3f} of the test's bound, max |error| {err:.6f}")
    del kv
    cache_bytes = 2 * b * smax * kh * hd * 2
    rows = []
    for ctx in DECODE_CTXS:
        n = max(2, int(-(-DECODE_COLD_BYTES // (cache_bytes * ctx / smax))))
        caches = [tuple(torch.randn((b, smax, kh, hd), generator=gen,
                                    device=dev).to(torch.bfloat16)
                        for _ in range(2)) for _ in range(n)]
        pos = torch.full((b,), ctx - 1, dtype=torch.long, device=dev)
        err, worst = check(*caches[0], pos, f"at context {ctx}")
        # the library yardstick reads [B, KH, ctx, hd] (copied outside the
        # timing) with the query heads grouped over them
        sdpa = [tuple(x[:, :ctx].transpose(1, 2).contiguous() for x in kv)
                for kv in caches]
        qh = q.transpose(1, 2).contiguous()
        turn = iter(range(1 << 30))

        def cycled(fn):
            return lambda: fn(*caches[next(turn) % n])

        def cycled_sdpa():
            ks, vs = sdpa[next(turn) % n]
            return F.scaled_dot_product_attention(qh, ks, vs,
                                                  enable_gqa=True)
        with torch.no_grad():
            ms = graph_ms(torch, cycled(lambda k, v: decode_attention(
                q, k, v, pos)), reps=4 * n)
            plain_ms = graph_ms(torch, cycled(lambda k, v: plain(
                q, k, v, pos)), reps=4)
            library_ms = graph_ms(torch, cycled_sdpa, reps=4 * n)
        nbytes = 2 * b * ctx * kh * hd * 2 + 2 * b * h * hd * 2
        b_ms, b_by = bound_ms(nbytes, 4 * b * h * ctx * hd, BF16_FLOP_PER_S)
        rows.append(dict(
            name=f"decode_attn@ctx{ctx}", route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces="none (models/attention.py decode_attention, plain)",
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms))
        log(f"[decode_attn] {b} rows at context {ctx} of {smax} ({h} heads "
            f"over {kh}, hd {hd}, {n} caches cycled): {ms:.4f} ms, "
            f"{b_ms / ms:.3f} of the bound {b_ms:.5f} ms by {b_by} "
            f"({ms / b_ms:.2f}x); plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {library_ms:.4f} ms; "
            f"{worst:.3f} of the test's bound; [serve] main path launches "
            f"{launches}; {card()}")
        del caches, sdpa
        _free(torch)
    return rows


def _rel_l2(torch, a, b) -> float:
    return (torch.linalg.vector_norm((a - b).float()) /
            torch.linalg.vector_norm(b.float()).clamp_min(1e-30)).item()


def _tile_rel_l2(torch, got, ref) -> float:
    """The worst relative L2 error of ``got`` against ``ref`` ([B, S, H,
    hd]) over tiles of FLASH_TILE sequence rows of one batch row and
    head (the last tile of a ragged S is short)."""
    import torch.nn.functional as F
    pad = -got.shape[1] % FLASH_TILE

    def tiles(x):
        x = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
        b, s, h, hd = x.shape
        return x.reshape(b, s // FLASH_TILE, FLASH_TILE, h, hd).square() \
            .sum((2, 4)).sqrt()
    err = tiles(got.float() - ref.float())
    return (err / tiles(ref).clamp_min(1e-30)).max().item()


def _int_diff(torch, a, b) -> int:
    return int((a != b).sum().item())


def _gating_tap(torch, record=None, replay=None):
    """A stand-in for ``models.moe``'s gating call: it records each call's
    router logits and outputs (weights, ids, phi) into ``record``, or
    returns the recorded outputs in order instead of computing them
    (``replay``), so that a second run routes every token exactly as the
    first did."""
    from repro_torch.models import moe as moe_lib
    orig = moe_lib.gating
    it = iter(replay or ())

    def gating(logits, k, impl="auto"):
        if replay is not None:
            return next(it)[1]
        out = orig(logits, k, impl)
        record.append((logits.clone(), tuple(x.clone() for x in out)))
        return out
    return gating


def _first_flips(torch, kern, plain, n_layers) -> list:
    """Where two steps' gating calls (``_gating_tap`` records, microbatch
    by microbatch, layer by layer) first give a token another expert set,
    in each microbatch: (layer, tokens flipped, the worst top-k margin of
    the plain step's router over them — its k-th largest logit less the
    next —, and the worst change of a logit between the two steps), the
    last two in bf16 ulps of the token's largest |logit|.  Later layers
    see hidden states that the flips changed."""
    out = []
    for i, ((lk, ok), (lp, op)) in enumerate(zip(kern, plain)):
        if i % n_layers == 0:
            found = False
        if found:
            continue
        ek, ep = ok[1].sort(-1).values, op[1].sort(-1).values
        flip = (ek != ep).any(-1)
        if not flip.any():
            continue
        found = True
        k = ep.shape[-1]
        top = lp.topk(k + 1, dim=-1).values
        ulp = torch.exp2(torch.floor(torch.log2(lp.abs().amax(-1))) - 7)
        margin = ((top[..., k - 1] - top[..., k]) / ulp)[flip]
        moved = ((lk - lp).abs().amax(-1) / ulp)[flip]
        out.append((i % n_layers, int(flip.sum()), margin.max().item(),
                    moved.max().item()))
    return out


def train_compare(torch, cfg, hyper, state, tokens, plan, fails, n_mb=None,
                  tag="train"):
    """Checks from one state on one batch ``tokens`` [B, S] in ``n_mb``
    (default TRAIN_MB) microbatches, before the loop trains: the full step
    through the kernels against the same step through the plain versions
    (every one of them; for a MoE model also the MoE ones only, with the
    attention kernel in both arms), the granulated step against the fused
    one, and the kernel step run twice (the same bits).  Of each step's new
    state only the parameters are kept."""
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.runtime.train import build_fused_step, build_grad_step
    n_mb = n_mb or TRAIN_MB
    ps, pc = plan
    mb, seq = tokens.shape[0] // n_mb, tokens.shape[1]
    moe = lm.n_moe_layers(cfg) > 0
    ints = ("expert_counts", "slot_counts", "dropped") if moe else ()

    def step(impl):
        new, metrics, opt_m = build_fused_step(cfg, hyper, impl)(
            state, {"tokens": tokens}, ps, pc, 1.0, n_mb)
        return new["params"], metrics, opt_m

    def mb0_grads(impl):
        grad_mb = build_grad_step(cfg, hyper, impl)[0]
        return grad_mb(state["params"], {"tokens": tokens[:mb]}, ps, pc, 0)

    def worst_leaf(a, b):
        return max(_rel_l2(torch, x, y) for x, y in
                   zip(tree_leaves(a), tree_leaves(b)))

    if moe:
        sk, mk, gk = _moe_step_compare(torch, cfg, tag, step, mb0_grads,
                                       ints, worst_leaf, fails)
    else:
        # no routing: the kernel step against the plain one directly
        sk, mk, _ = step("auto")
        gk, _ = mb0_grads("auto")
        sr, mr, _ = step("torch")
        gr, _ = mb0_grads("torch")
        loss_k, loss_r = mk["loss"].mean().item(), mr["loss"].mean().item()
        worst = worst_leaf(gk, gr)
        by_leaf = sorted(((_rel_l2(torch, x, y), name) for name, x, y in zip(
            _leaf_names(gk), tree_leaves(gk), tree_leaves(gr))),
            reverse=True)[:4]
        log(f"[{tag}] one step, kernels vs every plain version (same state "
            f"and batch {list(tokens.shape)} in {n_mb} microbatches): loss "
            f"{loss_k:.7f} vs {loss_r:.7f} (rel "
            f"{abs(loss_k - loss_r) / loss_r:.3g}, tolerance "
            f"{TRAIN_LOSS_RTOL}); microbatch-0 gradient leaves worst rel L2 "
            f"{worst:.4g} (tolerance {TRAIN_GRAD_RTOL}); the worst leaves "
            f"{[(n, round(e, 5)) for e, n in by_leaf]}")
        if not np.isfinite(loss_k) or \
                abs(loss_k - loss_r) > TRAIN_LOSS_RTOL * loss_r or \
                worst > TRAIN_GRAD_RTOL:
            fails.append(f"{tag}: the kernel step differs from the plain "
                         f"step")
        del sr, mr, gr
    # granulated (gradient per microbatch, summed, then apply) vs fused
    grad_mb, apply, _ = build_grad_step(cfg, hyper)
    acc, metrics = None, []
    for i in range(n_mb):
        g, m = grad_mb(state["params"],
                       {"tokens": tokens[i * mb:(i + 1) * mb]}, ps, pc,
                       i * mb * seq)
        acc = g if acc is None else tree_map(lambda a, b: a + b, acc, g)
        metrics.append(m)
    sg, _ = apply(state, acc, n_mb, 1.0)
    int_eq = all(torch.equal(torch.stack([m[key] for m in metrics]), mk[key])
                 for key in ints)
    pairs = list(zip(tree_leaves(sg["params"]), tree_leaves(sk)))
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    worst = max(_rel_l2(torch, a, b) for a, b in pairs)
    log(f"[{tag}] granulated vs fused step: integer metrics equal {int_eq}, "
        f"updated params equal bit for bit {bitwise} (worst rel L2 "
        f"{worst:.3g})")
    if not int_eq or worst > 1e-6:
        fails.append(f"{tag}: granulated and fused steps differ")
    del sg, acc, metrics
    # the kernel step again: the same bits?
    s2, _, _ = step("auto")
    again = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(s2), tree_leaves(sk)))
    log(f"[{tag}] the kernel step run twice from the same state gives the "
        f"same parameters bit for bit: {again}")
    if not again:
        fails.append(f"{tag}: the kernel step is not the same bits twice")
    del s2, sk, mk, gk


def _leaf_names(tree, prefix=""):
    """The leaves' paths in ``tree_leaves``' order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _moe_step_compare(torch, cfg, tag, step, mb0_grads, ints, worst_leaf,
                      fails):
    """``train_compare``'s kernel-vs-plain checks of a MoE model: the full
    kernel step against the plain one (router flips held to near-ties, the
    arithmetic on a plain step replaying the kernel step's expert choices),
    then against the MoE kernels' plain versions with the attention kernel
    in both.  Returns the kernel step's (params, metrics, microbatch-0
    gradients)."""
    from repro_torch.models import blocks, lm
    from repro_torch.models import moe as moe_lib
    gating = moe_lib.gating
    step_routes, mb0_routes = [], []
    try:
        moe_lib.gating = _gating_tap(torch, record=step_routes)
        sk, mk, _ = step("auto")
        moe_lib.gating = _gating_tap(torch, record=mb0_routes)
        gk, _ = mb0_grads("auto")
    finally:
        moe_lib.gating = gating
    loss_k = mk["loss"].mean().item()
    # every plain version: near-tied router logits can send a token to
    # another expert (the attention kernel and the plain attention round
    # bf16 at other points), and a flip changes the later layers' inputs.
    # So the integer metrics are reported, the first flips in each
    # microbatch are held to be near-ties, and the arithmetic is held on a
    # second plain step that replays the kernel step's expert choices
    plain_routes = []
    try:
        moe_lib.gating = _gating_tap(torch, record=plain_routes)
        sp, mp, _ = step("torch")
    finally:
        moe_lib.gating = gating
    loss_p = mp["loss"].mean().item()
    flips = {key: _int_diff(torch, mk[key], mp[key]) for key in ints}
    first = _first_flips(torch, step_routes, plain_routes,
                         lm.n_moe_layers(cfg))
    worst_margin = max((f[2] for f in first), default=0.0)
    log(f"[{tag}] kernels vs every plain version, first flipped expert "
        f"sets per microbatch (layer, tokens, worst plain top-k margin and "
        f"worst logit change, in bf16 ulps of the token's largest |logit|):"
        f" {[(a, b, round(c, 3), round(d, 3)) for a, b, c, d in first]}; "
        f"tolerance {FLIP_MARGIN_ULPS} ulps")
    if worst_margin > FLIP_MARGIN_ULPS:
        fails.append(f"{tag}: a token flipped at a top-k margin of "
                     f"{worst_margin} bf16 ulps, not a near-tie")
    del sp, mp, plain_routes
    try:
        moe_lib.gating = _gating_tap(torch, replay=step_routes)
        sr, mr, _ = step("torch")
        moe_lib.gating = _gating_tap(torch, replay=mb0_routes)
        gr, _ = mb0_grads("torch")
    finally:
        moe_lib.gating = gating
    loss_r = mr["loss"].mean().item()
    diffs = {key: _int_diff(torch, mk[key], mr[key]) for key in ints}
    worst = worst_leaf(gk, gr)
    log(f"[{tag}] one step, kernels vs every plain version (same state and "
        f"batch): loss {loss_k:.7f} vs {loss_p:.7f} (rel "
        f"{abs(loss_k - loss_p) / loss_p:.3g}), integer entries that "
        f"differ {flips} (router near-ties); with the plain step replaying "
        f"the kernel step's expert choices: loss {loss_r:.7f} (rel "
        f"{abs(loss_k - loss_r) / loss_r:.3g}, tolerance "
        f"{TRAIN_LOSS_RTOL}), integer entries that differ {diffs}, "
        f"microbatch-0 gradient leaves worst rel L2 {worst:.4g} (tolerance "
        f"{TRAIN_GRAD_RTOL})")
    if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * loss_p or \
            abs(loss_k - loss_r) > TRAIN_LOSS_RTOL * loss_r or \
            any(diffs.values()) or worst > TRAIN_GRAD_RTOL:
        fails.append(f"{tag}: the kernel step differs from the plain step")
    del sr, mr, gr, step_routes, mb0_routes
    # the MoE kernels' plain versions, attention through its kernel in both
    orig = blocks.flash_attention
    blocks.flash_attention = lambda q, k, v, impl="auto", **kw: orig(
        q, k, v, impl="auto", **kw)
    try:
        sm, mm, _ = step("torch")
        gm, _ = mb0_grads("torch")
    finally:
        blocks.flash_attention = orig
    diffs = {key: _int_diff(torch, mk[key], mm[key]) for key in ints}
    worst = worst_leaf(gk, gm)
    same_loss = torch.equal(mk["loss"], mm["loss"])
    log(f"[{tag}] one step, kernels vs the plain gating, dispatch and "
        f"combine (attention kernel in both): integer metrics "
        f"{'equal' if not any(diffs.values()) else diffs}; per-microbatch "
        f"losses equal bit for bit: {same_loss}; microbatch-0 gradient "
        f"leaves: worst rel L2 {worst:.4g}; expert_counts per layer of "
        f"microbatch 0: {mk['expert_counts'][0].tolist()}")
    if any(diffs.values()) or worst > TRAIN_GRAD_RTOL:
        fails.append(f"{tag}: the MoE kernels' step differs from their plain "
                     f"versions'")
    del sm, mm, gm
    return sk, mk, gk


def reshape_train_loop(torch, dev, cfg, batch, seq, n_mb, tag, fails,
                       compare=True):
    """``TrainLoop`` on ``cfg`` (f32 master weights) over a skewed
    ``TokenStream`` of ``batch`` x ``seq`` tokens a step in ``n_mb``
    microbatches, with ``MoEReshaper`` closing the loop (ep_ranks 2, tau
    0.2), and (``compare``) ``train_compare`` from its initial state
    before it trains.  Returns (the loop, its reshaper)."""
    from repro_torch.core.reshape_moe import MoEReshaper
    from repro_torch.core.skew import SkewParams
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import lm
    from repro_torch.runtime.loop import LoopConfig, TrainLoop
    from repro_torch.runtime.train import TrainHyper

    def stream():
        return TokenStream(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                           seed=SEED, class_alpha=TRAIN_ALPHA)

    reshaper = MoEReshaper(cfg, lm.n_moe_layers(cfg), ep_ranks=2,
                           params=SkewParams(eta=0.0, tau=0.2))
    hyper = TrainHyper()
    loop = TrainLoop(cfg, stream(), hyper,
                     LoopConfig(microbatches=n_mb, device=str(dev)),
                     reshaper=reshaper, seed=SEED)
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, "
        f"{cfg.moe.num_experts}+{cfg.moe.spare_slots} slots top-"
        f"{cfg.moe.top_k}, expert d_ff {cfg.moe.expert_d_ff}, vocab "
        f"{cfg.vocab}, {sum(p.numel() for p in _leaves(loop.state['params']))}"
        f" f32 params; global batch {batch} x {seq} in {n_mb} microbatches, "
        f"TokenStream class_alpha {TRAIN_ALPHA}, Reshape ep_ranks 2, tau 0.2")
    if compare:
        tokens = torch.as_tensor(stream().next()["tokens"], device=dev)
        train_compare(torch, cfg, hyper, loop.state, tokens,
                      loop._plan_args(), fails, n_mb=n_mb, tag=tag)
        _free(torch)
    return loop, reshaper


def moe_step_launches(nl, n_mb, remat="none") -> dict:
    """What the code launches in a training step of ``nl`` MoE layers and
    ``n_mb`` microbatches: per layer and microbatch, the forward's
    attention, gating, dispatch and combine (twice under a remat policy:
    the backward recomputes them, the kernels being no matrix product that
    "dots" keeps), and the backward's attention, combine (dispatch's
    gradient) and dispatch (combine's)."""
    fwd = 1 if remat == "none" else 2
    return {"flash_fwd": fwd * nl * n_mb, "flash_bwd": nl * n_mb,
            "moe_gating": fwd * nl * n_mb,
            "moe_dispatch": (fwd + 1) * nl * n_mb,
            "moe_combine": (fwd + 1) * nl * n_mb}


# AdamW settings under which a first step's change of each parameter is its
# clipped gradient (eps far above every gradient, lr eps, no decay, no
# warm-up), so two steps' changes compare as their gradients
LINEAR_OPT = dict(lr=1e3, eps=1e3, weight_decay=0.0, warmup_steps=1)


def train_step_checks(torch, cfg, state, tokens, plan, fails) -> None:
    """[train]'s production step and remat, from one state on one batch:
    ``build_train_step`` (its microbatches' gradients added as ``a + g /
    n_mb``, integer metrics summed) against the fused step (summed, then
    divided once): the loss within TRAIN_LOSS_RTOL, integer metrics equal,
    each parameter's change within TRAIN_GRAD_RTOL (under LINEAR_OPT, its
    clipped gradient); then the fused step under ``remat="dots"`` against
    ``"none"``, parameters and metrics bit for bit, each with its
    launches."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.train import (TrainHyper, build_fused_step,
                                           build_train_step)
    ps, pc = plan
    batch = {"tokens": tokens}
    b, seq = tokens.shape
    lin = TrainHyper(opt=adamw.AdamWCfg(**LINEAR_OPT))
    new_f, m_f, _ = build_fused_step(cfg, lin)(state, batch, ps, pc, 1.0,
                                               TRAIN_MB)
    step = build_train_step(cfg, step_shape("train", b, seq, TRAIN_MB), lin)
    step(state, batch, ps, pc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_t, m_t = step(state, batch, ps, pc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loss_f, loss_t = m_f["loss"].mean().item(), m_t["loss"].item()
    ints = {k: torch.equal(m_t[k], m_f[k].sum(0))
            for k in ("expert_counts", "slot_counts", "dropped")}
    worst = max(_rel_l2(torch, x - o, y - o) for o, x, y in zip(
        tree_leaves(state["params"]), tree_leaves(new_t["params"]),
        tree_leaves(new_f["params"])))
    log(f"[train] build_train_step vs the fused step (same state and batch "
        f"{list(tokens.shape)} in {TRAIN_MB} microbatches, AdamW "
        f"{LINEAR_OPT}): loss {loss_t:.7f} vs {loss_f:.7f} (tolerance "
        f"{TRAIN_LOSS_RTOL} relative), integer metrics equal {ints}, "
        f"worst leaf's change rel L2 {worst:.4g} (tolerance "
        f"{TRAIN_GRAD_RTOL}); a step {wall:.4f} s; {card()}")
    if abs(loss_t - loss_f) > TRAIN_LOSS_RTOL * abs(loss_f) or \
            not all(ints.values()) or worst > TRAIN_GRAD_RTOL:
        fails.append("train: build_train_step differs from the fused step")
    del new_f, new_t, m_f, m_t
    _free(torch)
    out, nl = {}, lm.n_moe_layers(cfg)
    for remat in ("none", "dots"):
        fused, walls = build_fused_step(cfg, TrainHyper(remat=remat)), []
        for _ in range(2):          # the first checkpoint imports dynamo
            out.pop(remat, None)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            new, metrics, _ = fused(state, batch, ps, pc, 1.0, TRAIN_MB)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            out[remat] = (new["params"], metrics)
            del new
        want = moe_step_launches(nl, TRAIN_MB, remat)
        got = {k: LAUNCHES[k] for k in want}
        log(f"[train] fused step, remat {remat}: {walls[1]:.4f} s (its "
            f"first call {walls[0]:.4f} s), launches {got} (the code "
            f"predicts {want})")
        if got != want:
            fails.append(f"train: the remat {remat} step launched {got}, "
                         f"the code predicts {want}")
    (p0, m0), (p1, m1) = out["none"], out["dots"]
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(p1),
                                                  tree_leaves(p0)))
    same_m = all(torch.equal(m1[k], m0[k]) for k in m0)
    log(f"[train] remat dots vs none: updated parameters equal bit for bit "
        f"{same}, metrics equal {same_m} (MoE metrics "
        f"{list(m1['expert_counts'].shape)}: one entry a layer)")
    if not same or not same_m:
        fails.append("train: the remat-dots step differs from remat none")
    del out, p0, p1
    _free(torch)


def held_bytes(tensors) -> int:
    """What the card's caching allocator counts as allocated for
    ``tensors`` (each rounded up to its 512-byte blocks)."""
    return sum(-(-t.untyped_storage().nbytes() // 512) * 512
               for t in tensors)


def train_steps(torch, loop, per_step, n, tag, fails, note=None,
                held=0) -> float:
    """The training main path: ``n`` steps of ``loop``, the launch counts
    set to 0 just before; each step's launches held to ``per_step`` (what
    the code predicts) and its loss to be finite, and ``note(h)`` added to
    each step's log line; the peak device memory is read over these steps
    alone, less ``held`` bytes that the caller keeps alive through them.
    Returns the steps' mean wall time."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    n_tok = loop.stream.global_batch * loop.stream.seq_len
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    prev, walls = dict(LAUNCHES), []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = loop.run(1)[-1]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        now = dict(LAUNCHES)
        delta = {k: now[k] - prev[k] for k in per_step}
        prev = now
        if delta != per_step:
            fails.append(f"{tag}: step {h['step']} launched {delta}, the "
                         f"code predicts {per_step}")
        if not np.isfinite(h["loss"]):
            fails.append(f"{tag}: step {h['step']} loss {h['loss']}")
        log(f"[{tag}] step {h['step']}: loss {h['loss']:.6f} grad_norm "
            f"{h['grad_norm']:.6f}{note(h) if note else ''}; "
            f"{walls[-1]:.4f} s, {n_tok / walls[-1]:.1f} training tok/s; "
            f"launches {delta}")
    wall = sum(walls) / len(walls)
    peak = torch.cuda.max_memory_allocated() - held
    gb, seq, mb = loop.stream.global_batch, loop.stream.seq_len, \
        loop.lc.microbatches
    kept = f" (less {held / 2 ** 30:.2f} GiB kept for a check)" \
        if held else ""
    log(f"[{tag}] {n} steps of {gb} x {seq}: mean {wall:.4f} s a step, "
        f"{n_tok / wall:.1f} training tok/s; launches {_nonzero(LAUNCHES)}; "
        f"peak device memory in these steps {peak / 2 ** 30:.2f} GiB{kept}")
    mfu_line(tag, loop.cfg, "train", gb, seq, wall, mb)
    dry_line(torch, tag, loop.cfg, "train", gb, seq, peak, mb)
    return wall


def reshape_note(reshaper):
    """``train_steps``' note for a Reshape loop: drops, slot counts and
    the reshaper's iterations and events."""
    def note(h):
        return (f" dropped {int(np.sum(h['dropped']))} (per layer "
                f"{np.asarray(h['dropped']).tolist()}) slot_counts (summed "
                f"over layers) {np.sum(h['slot_counts'], 0).tolist()}; "
                f"reshape iterations {reshaper.iterations}, events "
                f"{len(reshaper.events)}")
    return note


ADAMW_STEPS = 5


def adamw_check(torch, dev, cfg, fails) -> None:
    """``adamw.apply_`` (in place) against ``adamw.apply`` on the card:
    ADAMW_STEPS steps on ``cfg``'s f32 tree from one seed, gradients from
    the seed too, clipped in every other step; every leaf of the
    parameters and both moments bit for bit (the card's kernels may
    contract a multiply and an add where the CPU's do not: both paths must
    round at the same points)."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves, tree_map
    gen = torch.Generator(device=dev).manual_seed(SEED)
    opt = adamw.AdamWCfg(lr=1e-2, warmup_steps=2, total_steps=10)
    p_f = lm.init(cfg, gen, device=dev)
    p_i = tree_map(torch.clone, p_f)
    s_f, s_i = adamw.init(p_f), adamw.init(p_i)
    n = sum(x.numel() for x in tree_leaves(p_f))
    t0 = time.perf_counter()
    clipped = 0
    for step in range(ADAMW_STEPS):
        # a global norm about 3 (clipped to 1) or about 0.1 (not clipped)
        scale = (3.0 if step % 2 else 0.1) / n ** 0.5
        g = tree_map(lambda p: scale * torch.randn(
            p.shape, generator=gen, device=dev), p_f)
        p_f, s_f, m_f = adamw.apply(p_f, g, s_f, opt)
        count, m_i = adamw.apply_(p_i, g, s_i, opt)
        s_i = adamw.OptState(s_i.m, s_i.v, count)
        clipped += bool(m_f["grad_norm"] > opt.clip_norm)
    torch.cuda.synchronize()
    pairs = list(zip(tree_leaves(p_f) + tree_leaves(s_f.m) +
                     tree_leaves(s_f.v), tree_leaves(p_i) +
                     tree_leaves(s_i.m) + tree_leaves(s_i.v)))
    differ = sum(not torch.equal(a, b) for a, b in pairs)
    same = all(torch.equal(m_f[k], m_i[k]) for k in ("grad_norm", "lr"))
    log(f"[train] adamw.apply_ vs adamw.apply on {cfg.name}'s tree ({n} "
        f"f32 params), {ADAMW_STEPS} steps, clipped in {clipped}: leaves of "
        f"the parameters and moments that differ: {differ} of {len(pairs)}"
        f"; grad_norm and lr equal {same}; "
        f"{time.perf_counter() - t0:.2f} s")
    if differ or not same:
        fails.append("train: adamw.apply_ is not bit-equal to adamw.apply "
                     "on the card")
    del p_f, p_i, s_f, s_i, g
    _free(torch)


def train_phase(torch, dev, fails):
    """The training main path: ``TrainLoop.run`` on paper-moe-100m at full
    width through the kernels, with the Reshape loop closed.  Returns
    (the MoE kernels' JSON rows at training shapes, the main path's launch
    counts)."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm

    cfg = moe_cfg()
    adamw_check(torch, dev, cfg, fails)
    loop, reshaper = reshape_train_loop(torch, dev, cfg, TRAIN_BATCH,
                                        TRAIN_SEQ, TRAIN_MB, "train", fails)
    tokens = torch.as_tensor(TokenStream(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=SEED, class_alpha=TRAIN_ALPHA).next()["tokens"], device=dev)
    train_step_checks(torch, cfg, loop.state, tokens, loop._plan_args(),
                      fails)

    # warm-up step (first-use costs stay out of the main path), keeping the
    # kernels' inputs from their last calls: gating's last forward,
    # dispatch and combine as each other's backward, and the first layer's
    # flash backward
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe_dispatch import ops as dops
    from repro_torch.kernels.moe_gating import ops as gops
    _, seen = capture_kernel_inputs(
        torch, lambda: loop.run(1),
        [(gops, "gating_cuda"), (dops, "dispatch_cuda"),
         (dops, "combine_cuda"), (fa, "flash_bwd_cuda")])

    # the main path
    wall = train_steps(
        torch, loop, moe_step_launches(lm.n_moe_layers(cfg), TRAIN_MB),
        TRAIN_STEPS, "train", fails, reshape_note(reshaper))
    launches = dict(LAUNCHES)
    path = loop.engine.decisions[-1]["choice"] \
        if loop.engine.decisions else "?"
    log(f"[train] the engine's step path {path}; reshape events "
        f"{[(e.layer, e.hot_expert) for e in reshaper.events]}")

    # one more step under a CUDA-only trace: the busy share of a step
    wall_t, busy_us, by_name, _ = device_trace(torch, lambda: loop.run(1))
    busy = busy_us / 1e6 / wall
    log(f"[train] one more step under a CUDA-only trace (traced wall "
        f"{wall_t:.4f} s): device busy {busy_us:.0f} us; over the untraced "
        f"steps' mean wall {wall:.4f} s: busy {busy:.4f}, idle "
        f"{1 - busy:.4f}")
    log_trace("train", by_name, 10)
    # the engine picks the step path from measured costs; each path forced
    # for two more steps, for the record
    for path in ("fused", "granulated"):
        loop.lc.step_path = path
        ts = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop.run(1)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        log(f"[train] {path} step path forced: {ts} s a step")
    del loop
    _free(torch)
    rows, shapes = check_kernels(torch, seen, launches)
    for r in rows:
        r["name"] += "@train"
        log(f"[train] kernel {r['name']}: {r['ms'] * 1e3:.2f} us (plain "
            f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.4f} "
            f"us by {r['bound_by']}), integer outputs equal, max |err| "
            f"{r['max_abs_err']}, shapes and tolerance "
            f"{shapes[r['name'][:-6]]}")
    # the flash kernels on a layer's own inputs, and what a delta from the
    # bf16 o would cost there
    q, k, v, o32, _, do, _, window, _ = seen.pop("flash_bwd_cuda")
    flash_check(torch, "train", "flash on the first layer's inputs", q, k, v,
                do, window)
    o = o32.to(q.dtype)
    log(f"[train] on those inputs, a delta dO·o in place of sum P·dP "
        f"would move, from {delta_residue(torch, q, k, v, do, o, window)} "
        f"(of the exact f64 gradients)")
    return rows, launches


# [control]: the Amber control plane on the card.  Serving under control
# and the serve durable log's replay run paper-moe-100m at full width and
# depth on the graphed tick (4 slots); training with async checkpoints, a
# crash and recovery runs its full width at 2 of its 8 layers, since every
# checkpoint holds the f32 state (0.88 GB at 2 layers, 2.9 GB at 8) and
# the phase writes two of them; the Maestro engine is shared by the
# recovered loop and a serve engine.
CONTROL_LENS = (16, 24, 37, 50)
CONTROL_NEW = 64
CONTROL_BUDGET = 96             # b: the token budget that fires
CONTROL_TRAIN = dict(layers=2, batch=4, seq=256, mb=2, ckpt_every=2,
                     session_at=4, crash_after=5, steps=6)
CONTROL_WAIT = 120.0            # s any reply or thread may take


def serve_ticks(torch, eng, after2=None):
    """Tick ``eng`` until its queue and slots are empty (``after2()`` runs
    after its first 2 ticks), keeping every graph the ticks ran (a draft or
    weight publish drops the graphs it finds and the next tick captures
    new ones).  Returns the launches those graphs credited in the run:
    each graph's replays in it times its per-replay counts, and for a graph
    captured in the run its one eager warm-up step too; each graph's MoE
    kernel nodes are held to its per-replay counts."""
    from repro_torch.kernels import LAUNCHES
    start = {id(g): g.replays for g in eng._tick.graphs.values()}
    seen = {id(g): g for g in eng._tick.graphs.values()}
    ticks = 0
    while eng.queue or any(r is not None for r in eng.active):
        eng.tick()
        ticks += 1
        if ticks == 2 and after2 is not None:
            after2()
        for g in eng._tick.graphs.values():
            seen.setdefault(id(g), g)
    torch.cuda.synchronize()
    want = dict.fromkeys(LAUNCHES, 0)
    bad = []
    for key, g in seen.items():
        n = g.replays - start.get(key, -1)
        for k, c in g.per_replay.items():
            want[k] += n * c
        nodes = g.kernel_nodes()
        got = {"moe_gating": sum("gating_kernel" in k for k in nodes),
               "moe_dispatch": sum("dispatch_scatter" in k for k in nodes),
               "moe_combine": sum("combine_kernel" in k for k in nodes)}
        if any(got[k] != g.per_replay[k] for k in got):
            bad.append(f"a graph of {g.rows} rows holds MoE kernel nodes "
                       f"{got}, its capture counted {_nonzero(g.per_replay)}")
    return want, len(seen) - len(start), bad


def lap(name, marks) -> None:
    """Log the seconds since the last mark of ``marks`` as ``name``'s."""
    now = time.perf_counter()
    log(f"[control] {name}: {now - marks[-1]:.1f} s")
    marks.append(now)


def hold_launches(tag, launches, want, fails, need=MOE_KERNELS) -> None:
    """``launches`` (counted from 0 just before the sub-step, read just
    after) must be ``want`` and launch each of ``need``."""
    if launches != want:
        fails.append(f"control {tag}: launches {_nonzero(launches)}, the "
                     f"graphs and steps account for {_nonzero(want)}")
    missing = [k for k in need if not launches[k]]
    if missing:
        fails.append(f"control {tag}: never launched {missing}")


def control_serve(torch, dev, cfg, params, fails, marks):
    """[control] a and b: serving paper-moe-100m at full width under the
    control plane; returns the uninterrupted tokens."""
    import tempfile
    import threading

    from repro_torch.core import messages as M
    from repro_torch.core.breakpoints import GlobalCountBreakpoint
    from repro_torch.core.controller import Controller, ReplayingController
    from repro_torch.engine import Engine, ServeEngine, small_draft_cfg
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves, tree_map

    rng = np.random.default_rng(SEED + 11)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in CONTROL_LENS]
    max_len = max(CONTROL_LENS) + CONTROL_NEW + 16

    def engine(**kw):
        return ServeEngine(cfg, params, max_len=max_len, slots=len(prompts),
                           prefill_chunk=16, decode_chunk=4,
                           compact_decode=False, device=dev, **kw)

    # a. pause, inspect, update and resume from a thread mid-generation
    eng = engine()
    ref = eng.generate(prompts, CONTROL_NEW)          # also captures
    ctl = eng.engine.controller
    reqs = [eng.submit(p, CONTROL_NEW) for p in prompts]
    seen = {}
    ticks0 = eng.tick_no
    deadline = time.perf_counter() + CONTROL_WAIT

    def user():
        while eng.tick_no < ticks0 + 4 and time.perf_counter() < deadline:
            time.sleep(0.0005)
        seen["sent_at"] = eng.tick_no
        r = ctl.send(M.pause()).wait(CONTROL_WAIT)
        seen["paused_at"] = None if r is None else r["paused_at"]
        seen["inspect"] = ctl.send(M.inspect()).wait(CONTROL_WAIT)
        ctl.send(M.update(max_prefill_defer=2, decode_chunk=2)).wait(
            CONTROL_WAIT)
        ctl.send(M.resume()).wait(CONTROL_WAIT)

    reset_launches()
    t0 = time.perf_counter()
    th = threading.Thread(target=user)
    th.start()
    want, captured, bad = serve_ticks(torch, eng)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    th.join(CONTROL_WAIT)
    fails += [f"control a: {b}" for b in bad]
    hold_launches("a", launches, want, fails)
    out = np.stack([r.output() for r in reqs])
    info = seen.get("inspect") or {}
    lat = ctl.pause_latency[-1] if ctl.pause_latency else float("nan")
    paused = seen.get("paused_at")
    ok = np.array_equal(out, ref)
    if not ok:
        bad = np.argwhere(out != ref)[:5].tolist()
        fails.append(f"control a: tokens under control != the "
                     f"uninterrupted run's at {bad}")
    if th.is_alive() or paused is None or info.get("paused") is not True:
        fails.append(f"control a: the session did not complete "
                     f"(paused_at {paused}, inspect paused "
                     f"{info.get('paused')})")
    if (eng.decode_chunk, eng.engine.max_prefill_defer) != (2, 2):
        fails.append("control a: the update did not apply")
    kinds = [r.kind for r in ctl.log]
    log(f"[control] a: {len(prompts)} requests (prompts "
        f"{list(CONTROL_LENS)}), {CONTROL_NEW} new each, {eng.tick_no - ticks0}"
        f" ticks in {wall:.4f} s; a thread sent pause at tick "
        f"{seen.get('sent_at')}, paused at {paused}: pause latency "
        f"{None if paused is None else paused[0] - seen['sent_at']} ticks, "
        f"{lat * 1e3:.3f} ms (send to effect); inspect answered while paused "
        f"{info.get('paused')} at tick {info.get('tick')}; update "
        f"decode_chunk 2, max_prefill_defer 2, resume; control log {kinds}; "
        f"tokens equal the uninterrupted run's {ok}; launches "
        f"{_nonzero(launches)} (the graphs' replays: "
        f"{'equal' if launches == want else want})")

    lap("a", marks)

    # b. a durably logged schedule: a token budget that fires and a
    # garbage draft published as bf16 tensors on the card; then a crash
    # and a ReplayingController on a fresh engine
    dcfg = small_draft_cfg(cfg)
    dparams = lm.init(dcfg, torch.Generator(device=dev).manual_seed(SEED + 1),
                      device=dev)
    garbage = tree_map(lambda x: (-x).to(torch.bfloat16), dparams)

    def draft_engine(**kw):
        e = engine(spec_decode=True, draft_cfg=dcfg, draft_params=dparams,
                   **kw)
        force_arm(e, "spec:draft")
        return e

    def budget_run(e, schedule):
        """Serve the prompts on ``e``; ``schedule`` sends its messages after
        2 ticks; a thread resumes the budget's pause.  (tokens, the tick
        the budget paused at, launches, graphs' launches, wall)."""
        c = e.engine.controller
        rs = [e.submit(p, CONTROL_NEW) for p in prompts]
        fired = {}

        def resumer():
            end = time.perf_counter() + CONTROL_WAIT
            while not c.paused and time.perf_counter() < end:
                time.sleep(0.0005)
            fired["tick"] = e.tick_no
            c.send(M.resume())

        reset_launches()
        t0 = time.perf_counter()
        th = threading.Thread(target=resumer)
        th.start()
        w, _, bad = serve_ticks(torch, e, lambda: schedule(c))
        wall = time.perf_counter() - t0
        got = dict(LAUNCHES)
        th.join(CONTROL_WAIT)
        fails.extend(f"control b: {b}" for b in bad)
        if th.is_alive():
            fails.append("control b: the budget never paused the stream")
        return np.stack([r.output() for r in rs]), fired.get("tick"), got, \
            w, wall

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/serve_control.log"
        e1 = draft_engine(engine=Engine(durable_log=path))

        def schedule(c):
            c.send(M.set_breakpoint(GlobalCountBreakpoint(
                "budget", "emitted", target=CONTROL_BUDGET)))
            c.send(M.update(draft_params=garbage))

        out1, fire1, l1, w1, wall1 = budget_run(e1, schedule)
        hold_launches("b, logged run", l1, w1, fails)
        t0 = time.perf_counter()
        records = Controller.read_durable_log(path)
        t_read = time.perf_counter() - t0
        size = Path(path).stat().st_size
        logged = [(r.kind, r.step) for r in records]
        swap = [r for r in records if r.kind == "update"]
        back = tree_leaves(swap[0].payload["draft_params"]) if swap else []
        exact = len(back) == len(tree_leaves(garbage)) and all(
            b.dtype == torch.bfloat16 and b.device.type == "cpu" and
            torch.equal(b, g.cpu())
            for b, g in zip(back, tree_leaves(garbage)))
        if not exact:
            fails.append("control b: the logged draft did not read back "
                         "bf16 bit for bit")
        # the first run's draft, as it served after the swap
        live = [t.clone() for t in tree_leaves(e1.draft_params)]
        del e1                                        # "crash"
        _free(torch)

        rc = ReplayingController(records)
        e2 = draft_engine(engine=Engine(controller=rc))
        out2, fire2, l2, w2, wall2 = budget_run(e2, lambda c: None)
        hold_launches("b, replay", l2, w2, fails)
        replayed = [(r.kind, r.step) for r in rc.log
                    if r.kind in ("breakpoint", "update")]
        same_draft = all(torch.equal(a, b) for a, b in zip(
            live, tree_leaves(e2.draft_params)))
    for cond, msg in (
            (np.array_equal(out1, ref), "the logged run's tokens != the "
             "uninterrupted plain run's (a garbage draft changed a token)"),
            (np.array_equal(out2, out1), "the replayed tokens != the "
             "logged run's"),
            (fire1 is not None and fire1 == fire2, f"the budget paused at "
             f"tick {fire1}, in the replay at {fire2}"),
            (replayed == [x for x in logged if x[0] != "resume"],
             f"replayed effects {replayed} != logged {logged}"),
            (same_draft, "the replayed draft != the logged run's"),
            (logged[:2] == [("breakpoint", 2), ("update", 2)],
             f"logged {logged}")):
        if not cond:
            fails.append(f"control b: {msg}")
    log(f"[control] b: spec:draft forced, a budget of {CONTROL_BUDGET} "
        f"emitted tokens and update(draft_params=...) with "
        f"{len(tree_leaves(garbage))} bf16 tensors on {dev} "
        f"({sum(t.numel() for t in tree_leaves(garbage))} values) logged at "
        f"tick 2; durable log {logged}, {size} bytes, read back in "
        f"{t_read:.4f} s, the draft bf16 bit for bit {exact}; the budget "
        f"paused at tick {fire1}, a thread resumed; tokens equal the plain "
        f"uninterrupted run's {np.array_equal(out1, ref)}; crash, then a "
        f"ReplayingController on a fresh engine: replayed {replayed}, "
        f"paused at tick {fire2}, tokens bit-identical "
        f"{np.array_equal(out2, out1)}, its draft the logged run's "
        f"{same_draft}; walls {wall1:.4f} s, {wall2:.4f} s; launches "
        f"{_nonzero(l1)}, {_nonzero(l2)} (the graphs' replays and each "
        f"capture's warm-up step: {'equal' if (l1, l2) == (w1, w2) else (w1, w2)})")
    return ref


def control_train(torch, dev, cfg, fails, marks):
    """[control] c and d: training with async checkpoints, a user session
    from a thread, a crash and recovery; the engine shared with serving."""
    import tempfile
    import threading
    import warnings

    from repro_torch.core import messages as M
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.engine import ServeEngine
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.loop import LoopConfig, TrainLoop
    from repro_torch.runtime.train import TrainHyper

    tc = CONTROL_TRAIN
    ccfg = cut(cfg, tc["layers"])
    per_step = moe_step_launches(lm.n_moe_layers(ccfg), tc["mb"])
    zero = dict.fromkeys(LAUNCHES, 0)

    def steps_launches(n):
        return {**zero, **{k: n * v for k, v in per_step.items()}}

    def stream():
        return TokenStream(vocab=ccfg.vocab, seq_len=tc["seq"],
                           global_batch=tc["batch"], seed=SEED,
                           class_alpha=TRAIN_ALPHA)

    def lcfg(d, ckpt_every):
        return LoopConfig(microbatches=tc["mb"], ckpt_every=ckpt_every,
                          ckpt_dir=d, ckpt_async=True, device=str(dev))

    def jobs(loop):
        """Every job the loop's engine measures: (end, kind, seconds)."""
        rec, orig = [], loop.engine.observe

        def observe(job, seconds):
            rec.append((time.perf_counter(), job.kind, seconds))
            orig(job, seconds)
        loop.engine.observe = observe
        return rec

    def session(loop, n):
        """Run to ``session_at``, then a user thread pauses the loop,
        inspects it while paused, sets lr_scale 0.5 and resumes: its pause
        is queued before the loop's next poll, so it lands at
        (session_at, 0) in every run; then ``n`` more steps."""
        ctl = loop.controller
        loop.run(tc["session_at"])
        got = {}

        def user():
            got["paused_at"] = ctl.send(M.pause()).wait(CONTROL_WAIT)
            got["inspect"] = ctl.send(M.inspect()).wait(CONTROL_WAIT)
            ctl.send(M.update(lr_scale=0.5)).wait(CONTROL_WAIT)
            ctl.send(M.resume()).wait(CONTROL_WAIT)

        th = threading.Thread(target=user)
        th.start()
        while ctl.mailbox.empty() and th.is_alive():
            time.sleep(0.0005)
        loop.run(n)
        th.join(CONTROL_WAIT)
        paused = (got.get("paused_at") or {}).get("paused_at")
        if th.is_alive() or tuple(paused or ()) != (tc["session_at"], 0) \
                or not (got.get("inspect") or {}).get("paused"):
            fails.append(f"control c: the session landed at {paused}, "
                         f"inspect {got.get('inspect')}")
        return paused

    with tempfile.TemporaryDirectory() as tmp:
        # the uninterrupted run
        reset_launches()
        a = TrainLoop(ccfg, stream(), TrainHyper(), lcfg(f"{tmp}/a", 0),
                      seed=SEED)
        t0 = time.perf_counter()
        session(a, tc["steps"] - tc["session_at"])
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        hold_launches("c, run A", dict(LAUNCHES),
                      steps_launches(tc["steps"]), fails,
                      MOE_KERNELS + ("flash_fwd", "flash_bwd"))

        lap("c, run A", marks)

        # the run that checkpoints and crashes
        reset_launches()
        b = TrainLoop(ccfg, stream(), TrainHyper(),
                      lcfg(f"{tmp}/b", tc["ckpt_every"]), seed=SEED)
        rec = jobs(b)
        session(b, tc["crash_after"] - tc["session_at"])
        torch.cuda.synchronize()
        hold_launches("c, run B", dict(LAUNCHES),
                      steps_launches(tc["crash_after"]), fails)
        acked = b.ckpt.restorable_steps()
        del b                                         # "crash"
        _free(torch)
        snaps = [s for _, k, s in rec if k == "ckpt_snapshot"]
        persists = [(t - s, t) for t, k, s in rec if k == "ckpt_persist"]
        inflight, idle = [], []
        for t, k, s in rec:
            if k.startswith("train_step"):
                lo = t - s
                (inflight if any(p0 < t and lo < p1 for p0, p1 in persists)
                 else idle).append(s)

        lap("c, run B", marks)

        # recovery: restore + replay
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = TrainLoop.recover(ccfg, stream(), TrainHyper(),
                              lcfg(f"{tmp}/b", 0))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        start, pending = int(c.state["step"]), len(c.controller._replay)
        t0 = time.perf_counter()
        c.run(tc["steps"] - start)
        torch.cuda.synchronize()
        t_replay = time.perf_counter() - t0
        hold_launches("c, recovery", dict(LAUNCHES),
                      steps_launches(tc["steps"] - start), fails)
        same = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a.state["params"]), tree_leaves(c.state["params"])))
        if not same or c.lc.lr_scale != 0.5 or start != 4:
            fails.append(f"control c: recovered from step {start} "
                         f"(acked {acked}), lr_scale {c.lc.lr_scale}, params "
                         f"bit-identical to the uninterrupted run's {same}")
        log(f"[control] c: {ccfg.name} at {tc['layers']} of "
            f"{cfg.num_layers} layers (full width), {tc['batch']} x "
            f"{tc['seq']} in {tc['mb']} microbatches, ckpt_every "
            f"{tc['ckpt_every']} async; a thread paused at "
            f"({tc['session_at']}, 0), inspected while paused, set lr_scale "
            f"0.5, resumed; run A {tc['steps']} steps in {wall_a:.4f} s; run "
            f"B crashed after step {tc['crash_after']}, checkpoints acked "
            f"{acked}; snapshot {[round(s * 1e3, 3) for s in snaps]} ms, "
            f"persist {[round((p1 - p0) * 1e3, 3) for p0, p1 in persists]} "
            f"ms; a step with a persist in flight "
            f"{[round(s * 1e3, 3) for s in inflight]} ms, without "
            f"{[round(s * 1e3, 3) for s in idle]} ms (the engine's measured "
            f"steps)")
        log(f"[control] c: recovery from step {start} with {pending} "
            f"logged records to replay (the update is applied again; a "
            f"replay skips pause and resume): restore {t_restore:.4f} s + replay of "
            f"{tc['steps'] - start} steps {t_replay:.4f} s = recovery wall "
            f"{t_restore + t_replay:.4f} s; params bit-identical to the "
            f"uninterrupted run's {same}; lr_scale {c.lc.lr_scale}")

        lap("c, recovery", marks)

        # the recovered run again under torch's deterministic algorithms
        # (a report: where torch has no deterministic kernel it raises; with
        # warn_only it names each such op); torch.histc on the card, which
        # has none, shows the mode is live
        raised, warned, det_same = None, [], None
        try:
            torch.use_deterministic_algorithms(True)
            try:
                torch.histc(torch.ones(8, device=dev))
                control = "nothing (the mode is not live)"
            except RuntimeError as e:
                control = str(e).splitlines()[0][:120]
            d = TrainLoop.recover(ccfg, stream(), TrainHyper(),
                                  lcfg(f"{tmp}/b", 0))
            try:
                d.run(tc["steps"] - start)
                det_same = all(torch.equal(x, y) for x, y in zip(
                    tree_leaves(a.state["params"]),
                    tree_leaves(d.state["params"])))
            except RuntimeError as e:
                raised = str(e).splitlines()[0][:300]
                del d
                torch.use_deterministic_algorithms(True, warn_only=True)
                d = TrainLoop.recover(ccfg, stream(), TrainHyper(),
                                      lcfg(f"{tmp}/b", 0))
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    d.run(tc["steps"] - start)
                warned = sorted({str(w.message).splitlines()[0][:200]
                                 for w in caught})
                det_same = all(torch.equal(x, y) for x, y in zip(
                    tree_leaves(a.state["params"]),
                    tree_leaves(d.state["params"])))
            del d
        finally:
            torch.use_deterministic_algorithms(False)
        log(f"[control] c: under torch.use_deterministic_algorithms(True) "
            f"(torch.histc on the card raises: {control}) the recovered run "
            f"raised: {raised or 'nothing'}"
            + (f"; with warn_only its nondeterministic ops ({len(warned)}): "
               f"{warned}" if raised else "")
            + f"; its params equal the uninterrupted run's {det_same}")
        del a
        _free(torch)

    lap("c, determinism", marks)

    # d. one engine under the recovered loop and a serve engine
    rng = np.random.default_rng(SEED + 12)
    serve = ServeEngine(ccfg, c.state["params"], max_len=64, slots=2,
                        prefill_chunk=16, decode_chunk=4,
                        compact_decode=False, engine=c.engine, device=dev)
    reset_launches()
    for n in (12, 20):
        serve.submit(rng.integers(1, ccfg.vocab, (n,)).astype(np.int32), 8)
    want, _, bad = serve_ticks(torch, serve)
    fails.extend(f"control d: {b}" for b in bad)
    n_dec = len(c.engine.decisions)
    c.run(4)
    torch.cuda.synchronize()
    want = {k: want[k] + steps_launches(4)[k] for k in want}
    hold_launches("d", dict(LAUNCHES), want, fails,
                  MOE_KERNELS + ("flash_fwd", "flash_bwd"))
    paths = [{k: v for k, v in dd.items() if k != "decision"}
             for dd in list(c.engine.decisions)
             if dd["decision"] == "step_path"]
    after = [{k: v for k, v in dd.items() if k != "decision"}
             for dd in list(c.engine.decisions)[n_dec:]
             if dd["decision"] == "step_path"]
    kinds = dict(c.engine.jobs_run)
    if not ({"serve_prefill", "serve_decode"} <= set(kinds) and
            any(k.startswith("train_step") for k in kinds)):
        fails.append(f"control d: the shared engine ran {kinds}")
    log(f"[control] d: one Engine under the recovered TrainLoop and a "
        f"ServeEngine (2 requests, then 4 more steps): jobs_run {kinds}; "
        f"step-path decisions of the loop {paths}; after the serve "
        f"{after}; train_step_fused EMA "
        f"{c.engine.costs.estimate('train_step_fused')}, granulated "
        f"{c.engine.costs.estimate('train_step_granulated')} (prior "
        f"0.10 s until measured)")


def control_phase(torch, dev, fails) -> None:
    """[control]: the Amber control plane on the card (see CONTROL_*)."""
    from repro_torch.models import lm
    cfg = moe_cfg()
    marks = [time.perf_counter()]
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)
    control_serve(torch, dev, cfg, params, fails, marks)
    lap("b", marks)
    del params
    _free(torch)
    control_train(torch, dev, cfg, fails, marks)
    lap("d", marks)
    _free(torch)
    log(f"[control] the phase {marks[-1] - marks[0]:.1f} s; {card()}")


def gemma3_phase(torch, dev, fails) -> list:
    """gemma3-1b at full width (26 layers: 22 ``local`` over a window of
    1024 keys with a rolling decode cache, 4 ``attn``; d_model 1152, 4
    heads of 256 with one KV head, d_ff 6912, a tied vocab of 262144),
    random weights from the seed: a. ``lm.forward`` on GEMMA_FWD tokens,
    the main path (one ``flash_fwd`` launch a layer, counts set to 0 just
    before and read just after), then again under a CUDA-only trace; b. the
    flash kernels forward and backward against their plain version on the
    last ``local`` layer's inputs captured from that forward, timed beside
    ``scaled_dot_product_attention``; c. forward vs step-by-step decode; d.
    each block type's last layer, forward vs decode past the window (the
    ring wraps); e. ``BatchedServer.generate`` on GEMMA_PROMPT_LENS prompts
    (one past the window) after a warm-up that captures the tick's graph,
    one decode-attention launch a layer and replay; f. greedy ``ServeEngine`` vs ``generate_static`` on prompts crossing the
    window, at its first GEMMA_STATIC_LAYERS layers; g. ``TrainLoop`` with
    f32 master weights: one microbatch through
    the kernels against the plain versions, a warm-up step, then
    GEMMA_STEPS steps of the main path, each step's flash launches checked.
    Returns the JSON rows flash_fwd@gemma3 and flash_bwd@gemma3."""
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.models.attention import chunked_attention
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.loop import LoopConfig, TrainLoop
    from repro_torch.runtime.serve import BatchedServer
    from repro_torch.runtime.train import TrainHyper, build_grad_step

    tag = "gemma3"
    cfg = get_arch("gemma3-1b")
    n_layers = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = lm.init(cfg, gen, dtype=torch.bfloat16, device=dev)
    log(f"[{tag}] {cfg.name}: {n_layers} layers {lm.type_counts(cfg)}, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd} with "
        f"{cfg.n_kv_heads} KV head, window {cfg.window}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab} (tied), "
        f"{sum(p.numel() for p in _leaves(params))} params (bf16)")
    rng = np.random.default_rng(SEED)

    def tokens(b, s):
        return torch.as_tensor(rng.integers(1, cfg.vocab, (b, s)),
                               dtype=torch.long, device=dev)

    def step_time(name, t0):
        log(f"[{tag}] {name}: {time.perf_counter() - t0:.1f} s")
        return time.perf_counter()

    t_step = time.perf_counter()
    # a. the forward: a warm-up at the main path's shape, then the main
    # path, keeping the last flash call's inputs (the last layer, a local
    # one; fresh tensors, never written again)
    with torch.no_grad():
        lm.forward(params, {"tokens": tokens(*GEMMA_FWD)}, cfg)
        toks = tokens(*GEMMA_FWD)
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (logits, _), seen = capture_kernel_inputs(
            torch, lambda: lm.forward(params, {"tokens": toks}, cfg),
            [(fa, "flash_fwd_cuda")], clone=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        fwd_launches = dict(LAUNCHES)
        if fwd_launches["flash_fwd"] != n_layers:
            fails.append(f"{tag}: {fwd_launches['flash_fwd']} flash_fwd "
                         f"launches in the forward, expected {n_layers}")
        if tuple(logits.shape) != GEMMA_FWD + (cfg.vocab,) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{tag}: bad forward logits")
        n_tok = GEMMA_FWD[0] * GEMMA_FWD[1]
        log(f"[{tag}] forward {list(GEMMA_FWD)}: {wall:.4f} s, "
            f"{n_tok / wall:.1f} tok/s, launches {_nonzero(fwd_launches)}")
        mfu_line(tag, cfg, "prefill", *GEMMA_FWD, wall)
        dry_line(torch, tag, cfg, "prefill", *GEMMA_FWD, peak)
        del logits
        # the trace's names are demangled, the graph's nodes mangled
        kern, node = "flash_fwd_mma_kernel<256>", "flash_fwd_mma_kernelILi256E"
        n_k = graph_kernel_counts(
            torch, lambda: lm.forward(params, {"tokens": toks}, cfg),
            [node])[node]
        if n_k != n_layers:
            fails.append(f"{tag}: {n_k} {kern} kernel nodes in a graph of "
                         f"the forward, expected {n_layers}")
        wall_t, busy_us, by_name, short = device_trace(
            torch, lambda: lm.forward(params, {"tokens": toks}, cfg),
            lost=lambda table: n_layers - sum(
                v[0] for k, v in table.items() if kern in k), tag=tag)
        busy = busy_us / 1e6 / wall
        log(f"[{tag}] forward again under a CUDA-only trace (traced wall "
            f"{wall_t:.4f} s): device busy {busy_us:.0f} us; over the "
            f"untraced forward's wall {wall:.4f} s: busy {busy:.4f}, idle "
            f"{1 - busy:.4f}{partial(short)}")
        log_trace(tag, by_name, 8)
        log(f"[{tag}] {kern}: {n_k} kernel nodes in a graph of the "
            f"forward (one a layer: {n_layers})")
    t_step = step_time("a. forward", t_step)

    # b. the flash kernels on the last local layer's inputs
    q, k, v, _, window, _ = seen["flash_fwd_cuda"]
    del seen, toks
    if window != cfg.window:
        fails.append(f"{tag}: the last layer's flash ran with window "
                     f"{window}, expected {cfg.window}")
    do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    o, o32, lse, errs, po, ps = flash_check(
        torch, tag, "flash on the last local layer's inputs", q, k, v, do,
        window)
    log(f"[{tag}] on those inputs, a delta dO·o in place of sum P·dP "
        f"would move, from {delta_residue(torch, q, k, v, do, o, window)} "
        f"(of the exact f64 gradients)")
    b, s, h, hd = q.shape
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    pos = torch.arange(s, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & \
        (pos[None, :] > pos[:, None] - window)
    with torch.no_grad():
        fwd_t = dict(
            ms=graph_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, True,
                                                         window), reps=10),
            plain_ms=graph_ms(torch, lambda: chunked_attention(
                q, k, v, window=window), reps=10),
            library_ms=graph_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask), reps=10))
        causal_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), reps=10)
        bwd_t = dict(ms=graph_ms(torch, lambda: fa.flash_bwd_cuda(
            q, k, v, o32, lse, do, True, window), reps=10))
    bwd_t["plain_ms"] = event_ms(torch, lambda: torch.autograd.grad(
        po, ps, do, retain_graph=True))
    ls = [x.clone().requires_grad_(True) for x in (qh, kh, vh)]
    lo = F.scaled_dot_product_attention(*ls, attn_mask=mask)
    bwd_t["library_ms"] = event_ms(torch, lambda: torch.autograd.grad(
        lo, ls, doh, retain_graph=True))
    rows = []
    for name, bwd, err, t in (
            ("flash_fwd", False, errs["o"], fwd_t),
            ("flash_bwd", True, max(errs["dq"], errs["dk"], errs["dv"]),
             bwd_t)):
        b_ms, b_by = flash_bound(b, s, h, hd, 2, bwd, window)
        nbytes, flops = flash_work(b, s, h, hd, 2, bwd, window)
        lib = ", its backward by autograd" if bwd else ""
        rows.append(dict(
            name=f"{name}@{tag}", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/flash_attention.py:58",
            launches=fwd_launches[name], max_abs_err=err, ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=t["library_ms"]))
        log(f"[{tag}] {name} at {[b, s, h, hd]}, window {window}: "
            f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
            f"{b_ms:.5f} ms by {b_by}: {nbytes} bytes, "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms, {flops} operations, "
            f"{flops / BF16_FLOP_PER_S * 1e3:.5f} ms; "
            f"scaled_dot_product_attention with the "
            f"window as a boolean mask{lib}: {t['library_ms']:.4f} ms; by "
            f"CUDA-graph replay but the plain and the library backward, "
            f"timed between events)")
    log(f"[{tag}] scaled_dot_product_attention causal only (no window, so "
        f"more work than the function): {causal_ms:.4f} ms")
    del q, k, v, do, o, o32, lse, po, ps, qh, kh, vh, doh, mask, ls, lo
    _free(torch)
    t_step = step_time("b. flash", t_step)

    with torch.no_grad():
        # c. forward == step-by-step decode; d. each block type past the
        # window
        forward_decode_check(torch, cfg, params, tokens(*EQUIV_FWD), tag,
                             GEMMA_ATOL, "attention", fails)
        t_step = step_time("c. forward vs decode", t_step)
        block_decode_check(torch, cfg, params, tokens(1, GEMMA_BLOCK_LEN),
                           tag, fails)
        t_step = step_time("d. blocks past the window", t_step)

    # e. serving, one prompt past the window
    srv = BatchedServer(cfg, params, max_len=max(GEMMA_PROMPT_LENS) +
                        GEMMA_NEW + 16, slots=len(GEMMA_PROMPT_LENS),
                        prefill_chunk=16, decode_chunk=4,
                        compact_decode=False, device=dev)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in GEMMA_PROMPT_LENS]
    srv.generate([p[:16] for p in prompts], 4)      # captures the graph
    eng = srv.engine()
    replays0 = eng._tick.graphed.replays
    reqs, wall, launches = timed_generate(torch, eng, prompts, GEMMA_NEW)
    out = np.stack([r.output() for r in reqs])
    if out.shape != (len(prompts), GEMMA_NEW) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"{tag}: bad serve output {out.shape}")
    log(f"[{tag}] serve {len(prompts)} requests, prompts "
        f"{list(GEMMA_PROMPT_LENS)}, {GEMMA_NEW} new each: {wall:.4f} s, "
        f"{out.size / wall:.1f} generated tok/s "
        f"({sum(GEMMA_PROMPT_LENS) / wall:.1f} prompt tok/s), "
        f"{eng._tick.graphed.replays - replays0} replays of the tick's graph, "
        f"{eng._tick.captures} capture; launches {_nonzero(launches)}")
    replays = eng._tick.graphed.replays - replays0
    per = eng._tick.graphed.per_replay["decode_attn"]
    if not launches["decode_attn"] == replays * per > 0 or \
            per != cfg.num_layers:
        fails.append(f"{tag} serve: {launches['decode_attn']} decode_attn "
                     f"launches, not {replays} replays x {per} (one a "
                     f"layer, {cfg.num_layers})")
    del srv, eng, reqs
    _free(torch)
    t_step = step_time("e. serve", t_step)

    # f. engine == static on equal-length prompts crossing the window, at
    # the first GEMMA_STATIC_LAYERS layers
    fcfg = cut(cfg, GEMMA_STATIC_LAYERS)
    srv = BatchedServer(fcfg, first_layers(params, fcfg),
                        max_len=GEMMA_STATIC[1] + GEMMA_NEW + 16,
                        slots=GEMMA_STATIC[0], prefill_chunk=16,
                        decode_chunk=4, compact_decode=False, device=dev)
    batch = rng.integers(1, cfg.vocab, GEMMA_STATIC).astype(np.int32)
    t0 = time.perf_counter()
    ref = srv.generate_static(batch, GEMMA_NEW)
    t_static = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = srv.generate(batch, GEMMA_NEW)
    t_engine = time.perf_counter() - t0
    if not np.array_equal(got, ref):
        bad = np.argwhere(got != ref)[:5].tolist()
        fails.append(f"{tag}: ServeEngine != generate_static at {bad}")
    log(f"[{tag}] ServeEngine (graphed tick) vs generate_static on "
        f"{list(GEMMA_STATIC)} + {GEMMA_NEW} (past the window of "
        f"{cfg.window}) at {fcfg.num_layers} of {n_layers} layers "
        f"{lm.type_counts(fcfg)}: equal {np.array_equal(got, ref)}, engine "
        f"{t_engine:.4f} s, static {t_static:.4f} s")
    del srv, params
    _free(torch)
    t_step = step_time("f. engine vs static", t_step)

    # g. training
    gb, seq, n_mb = GEMMA_TRAIN
    mb = gb // n_mb
    hyper = TrainHyper()
    loop = TrainLoop(cfg, TokenStream(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=gb, seed=SEED), hyper,
                     LoopConfig(microbatches=n_mb, device=str(dev)),
                     seed=SEED)
    first = torch.as_tensor(TokenStream(
        vocab=cfg.vocab, seq_len=seq, global_batch=gb,
        seed=SEED).next()["tokens"][:mb], device=dev)
    # one microbatch from the initial state through the kernels and
    # through the plain versions
    res = {impl: build_grad_step(cfg, hyper, impl)[0](
        loop.state["params"], {"tokens": first}, None, None, 0)
        for impl in ("auto", "torch")}
    (gk, mk), (gp, mp) = res["auto"], res["torch"]
    loss_k, loss_p = mk["loss"].item(), mp["loss"].item()
    worst = max(_rel_l2(torch, a, c) for a, c in
                zip(tree_leaves(gk), tree_leaves(gp)))
    log(f"[{tag}] train: one microbatch {list(first.shape)}, kernels vs "
        f"plain versions: loss {loss_k:.7f} vs {loss_p:.7f} (rel "
        f"{abs(loss_k - loss_p) / loss_p:.3g}, tolerance "
        f"{TRAIN_LOSS_RTOL}); gradient leaves worst rel L2 {worst:.4g} "
        f"(tolerance {TRAIN_GRAD_RTOL})")
    if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * loss_p or \
            worst > TRAIN_GRAD_RTOL:
        fails.append(f"{tag}: the kernel training step differs from the "
                     f"plain one")
    del res, gk, mk, gp, mp
    _free(torch)
    loop.run(1)                                 # warm-up
    per_step = {"flash_fwd": n_layers * n_mb, "flash_bwd": n_layers * n_mb}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    prev, walls = dict(LAUNCHES), []
    for _ in range(GEMMA_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = loop.run(1)[-1]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        now = dict(LAUNCHES)
        delta = {key: now[key] - prev[key] for key in per_step}
        prev = now
        if delta != per_step:
            fails.append(f"{tag}: train step {hist['step']} launched "
                         f"{delta}, the code predicts {per_step}")
        if not np.isfinite(hist["loss"]):
            fails.append(f"{tag}: train step {hist['step']} loss "
                         f"{hist['loss']}")
        log(f"[{tag}] train step {hist['step']}: loss {hist['loss']:.6f} "
            f"grad_norm {hist['grad_norm']:.6f}; {walls[-1]:.4f} s, "
            f"{gb * seq / walls[-1]:.1f} training tok/s; launches {delta}")
    train_launches = dict(LAUNCHES)
    wall = sum(walls) / len(walls)
    log(f"[{tag}] train {GEMMA_STEPS} steps of {gb} x {seq} in {n_mb} "
        f"microbatches: mean {wall:.4f} s a step, {gb * seq / wall:.1f} "
        f"training tok/s; launches {_nonzero(train_launches)}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    mfu_line(tag, cfg, "train", gb, seq, wall, n_mb)
    dry_line(torch, tag, cfg, "train", gb, seq,
             torch.cuda.max_memory_allocated(), n_mb)
    rows[1]["launches"] = train_launches["flash_bwd"]
    del loop
    _free(torch)
    step_time("g. train", t_step)
    return rows


# [olmoe], [qwen3moe], [dense], [qwen2vl], [whisper]: the reference's last
# six configs at their published widths, random bf16 weights drawn on the
# card from a generator seeded SEED, depth cut only where 80 GB or the run's
# time forces it.  olmoe-1b-7b: the forward's [B, S]; 8 served prompts of
# two lengths, their new tokens; training's layers (the TrainLoop's step
# updates the parameters and moments in place: 16 B a parameter of state,
# the f32 gradient sum and a bf16 copy of the weights, so 4 of 16 layers,
# 2.29 B parameters), the layers of ``train_compare`` (its functional steps
# hold a second state beside the first, so 2), global batch, sequence,
# microbatches and steps
OLMOE_FWD = (4, 1024)
OLMOE_PROMPT_LENS = (16,) * 4 + (128,) * 4
OLMOE_NEW = 16
OLMOE_TRAIN = dict(layers=4, compare_layers=2, batch=4, seq=1024, mb=2,
                   steps=3)
# qwen3-moe-235b-a22b cut to 6 of 94 layers (36 GB of bf16 weights); the
# forward; 4 prompts of one length served on 4 slots
QWEN3_LAYERS = 6
QWEN3_FWD = (2, 1024)
QWEN3_PROMPT = (4, 48)
QWEN3_NEW = 8
# the dense configs and the depth each runs at (None: all of it):
# starcoder2-7b 20 GB, yi-34b 16 of 60 layers 20 GB, command-r-plus-104b 8
# of 64 layers 31 GB; each forward [1, 2048], 2 prompts served on 2 slots
DENSE = (("starcoder2-7b", None), ("yi-34b", 16),
         ("command-r-plus-104b", 8))
DENSE_FWD = (1, 2048)
DENSE_PROMPT = (2, 32)
DENSE_NEW = 8
# the new tokens of each request in a serve's rate run (after the run that
# the static oracle checks): decode dominates its wall
SERVE_RATE_NEW = 256
# qwen2-vl-7b at full depth: the forward's [B, S], its first 16 x 16
# positions a patch grid of (t, h, w) ids, the rest text; served like qwen3
QWEN2VL_FWD = (2, 1024)
QWEN2VL_GRID = (16, 16)
# whisper-base at full depth: the encoder's frames [B, enc_seq, d_model],
# the decoder's tokens (its forward and its step-by-step decode against the
# precomputed cross K/V), the reference's forward-vs-decode tolerance
# (tests/test_serve_consistency.py), the decode steps of each fault the
# check must catch, training's global batch, sequence, microbatches and
# steps
WHISPER_B, WHISPER_SEQ = 4, 448
WHISPER_ATOL, WHISPER_RTOL = 0.15, 0.1
WHISPER_CONTROL_STEPS = 64
WHISPER_TRAIN = dict(batch=4, seq=448, mb=2, steps=3)


def fused_moe(cfg):
    """``cfg`` with the fused gating and dispatch flags on (the kernels'
    path)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, fused_gating=True, fused_dispatch=True))


def cut(cfg, layers):
    """``cfg`` cut to its first ``layers`` layers (None: all of them)."""
    if layers is None or layers >= cfg.num_layers:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers,
                               layer_pattern=cfg.pattern[:layers])


def first_layers(params, cfg):
    """``params`` of a deeper model cut to ``cfg``'s layers: each stacked
    block type's first occurrences (views)."""
    from repro_torch.models import lm
    out = dict(params)
    for t, n in lm.type_counts(cfg).items():
        if t != "shared_attn":
            out[t] = {k: v[:n] for k, v in params[t].items()}
    return out


def model_init(torch, cfg, dev, tag):
    """Random bf16 weights drawn on the card from a generator seeded SEED
    (drawn in bf16: an f32 draw of qwen3's 36 GB would not fit beside its
    copy); logs the model."""
    from repro_torch.models import lm
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = lm.init(cfg, gen, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in _leaves(params))
    moe = "" if cfg.moe is None else \
        (f", {cfg.moe.num_experts} experts + {cfg.moe.spare_slots} spare "
         f"slots top-{cfg.moe.top_k}, expert d_ff {cfg.moe.expert_d_ff}")
    log(f"[{tag}] {cfg.name}: {cfg.num_layers} layers "
        f"{lm.type_counts(cfg)}, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads of {cfg.hd}, {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}"
        f"{moe}, vocab {cfg.vocab} "
        f"({'tied' if cfg.tie_embeddings else 'untied'}); "
        f"{n} params, {2 * n / 2 ** 30:.2f} GiB in bf16, drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    return params


def forward_main(torch, tag, cfg, params, batch, want, fails, targets=None,
                 kinds=None):
    """The forward's main path on ``batch``: a warm-up, then the counted
    run (counts set to 0 just before and read just after; ``want`` {kernel:
    launches}), then the same forward under a CUDA-only trace (busy share
    of the counted run's wall, device time by kernel).  ``targets`` are the
    wrappers whose last calls' inputs are kept (fresh tensors, kept as
    they are); ``kinds`` (module, wrapper name, key) counts the counted
    run's calls of one wrapper by ``key(args)``.  Returns (launches, the
    kept inputs, the counts by kind)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm

    def run():
        return lm.forward(params, batch, cfg)[0]

    with torch.no_grad():
        run()
        counted, by_kind = run, {}
        if kinds is not None:
            def counted():
                out, found = shape_counts(torch, run, *kinds)
                by_kind.update(found)
                return out
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, seen = capture_kernel_inputs(torch, counted, targets or [],
                                             clone=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(LAUNCHES)
        b, s = batch["tokens"].shape
        if tuple(logits.shape) != (b, s, cfg.vocab) or \
                not torch.isfinite(logits).all():
            fails.append(f"{tag}: bad forward logits {tuple(logits.shape)}")
        del logits
        got = {k: launches[k] for k in want}
        if got != want:
            fails.append(f"{tag}: forward launched {got}, the code "
                         f"predicts {want}")
        wall_t, busy_us, by_name, _ = device_trace(torch, run)
    busy = busy_us / 1e6 / wall
    log(f"[{tag}] forward {[b, s]}: {wall:.4f} s, {b * s / wall:.1f} tok/s, "
        f"launches {_nonzero(launches)}; again under a CUDA-only trace "
        f"(traced wall {wall_t:.4f} s): device busy {busy_us:.0f} us, busy "
        f"{busy:.4f}, idle {1 - busy:.4f} of the counted run's wall")
    log_trace(tag, by_name, 6)
    mfu_line(tag, cfg, "prefill", b, s, wall)
    dry_line(torch, tag, cfg, "prefill", b, s, peak)
    return launches, seen, by_kind


def oracle_cfg(cfg, slots, rows):
    """The static oracle's config for an engine of ``slots`` slots checked
    on batches of ``rows`` rows: for an MoE model a capacity at which the
    oracle's expert products have the engine's rows (each of its slots is
    a group of one token, so ``slots`` x capacity(1)), which drops nothing.
    cuBLAS may round a product's rows by its height, so the heights are
    kept the same."""
    from repro_torch.models import moe as moe_lib
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    want = slots * moe_lib.capacity(cfg, 1)
    cf = want * m.num_experts / (rows * m.top_k)
    out = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=cf))
    assert moe_lib.capacity(out, rows) == want, (cf, want)
    return out


def serve_static(torch, dev, tag, cfg, params, prompts, max_new, slots,
                 fails):
    """Greedy serving of ``prompts`` through ``BatchedServer`` on ``slots``
    slots (a warm-up captures the tick's graph; launch counts set to 0
    just before the served run and read just after: exactly the replays
    of the tick's graphs times their per-replay counts, and for an MoE
    model every MoE kernel launched); the same prompts again with
    SERVE_RATE_NEW new tokens each for the serving rate; then every output
    of the first run against ``generate_static`` on batches of ``slots``
    rows of prompts of one length, filled up with copies, at
    ``oracle_cfg``'s capacity; at a parting, the static loop's top-2
    margin there is logged.  Returns the first run's launches."""
    from repro_torch.runtime.serve import BatchedServer
    max_len = max(map(len, prompts)) + max(max_new, SERVE_RATE_NEW) + 16
    srv = BatchedServer(cfg, params, max_len=max_len, slots=slots,
                        prefill_chunk=16, decode_chunk=4,
                        compact_decode=False, device=dev)
    srv.generate([p[:16] for p in prompts], 4)        # captures the graph
    eng = srv.engine()
    graphs = dict(eng._tick.graphs)
    since = {n: g.replays for n, g in graphs.items()}
    reqs, wall, launches = timed_generate(torch, eng, prompts, max_new)
    out = np.stack([r.output() for r in reqs])
    want = graph_launches(graphs, since)
    if launches != want:
        fails.append(f"{tag}: serve launches {_nonzero(launches)} are not "
                     f"the graphs' replays' {_nonzero(want)}")
    if cfg.moe is not None and not all(launches[k] for k in MOE_KERNELS):
        fails.append(f"{tag}: an MoE kernel never launched in the serve")
    log(f"[{tag}] serve {len(prompts)} requests on {slots} slots, prompts "
        f"{[len(p) for p in prompts]}, {max_new} new each (the run the "
        f"static oracle checks, prefill-heavy): {wall:.4f} s, "
        f"{sum(g.replays - since[n] for n, g in graphs.items())} replays, "
        f"launches {_nonzero(launches)} (replays x per replay)")
    # the serving rate, where decode dominates the wall
    since = {n: g.replays for n, g in eng._tick.graphs.items()}
    rate_reqs, rate_wall, _ = timed_generate(torch, eng, prompts,
                                             SERVE_RATE_NEW)
    got = sum(len(r.output()) for r in rate_reqs)
    replays = sum(g.replays - since.get(n, 0)
                  for n, g in eng._tick.graphs.items())
    log(f"[{tag}] serving rate: {len(prompts)} requests on {slots} slots, "
        f"the same prompts, {SERVE_RATE_NEW} new each: {rate_wall:.4f} s, "
        f"{got / rate_wall:.1f} generated tok/s, {replays} replays, "
        f"{rate_wall / replays * 1e3:.3f} ms a replay")
    if got != len(prompts) * SERVE_RATE_NEW:
        fails.append(f"{tag}: the rate run generated {got} tokens")
    del srv, eng, rate_reqs
    ocfg = oracle_cfg(cfg, slots, slots)
    oracle = BatchedServer(ocfg, params, max_len=max_len, device=dev)
    t0 = time.perf_counter()
    parted = []
    for n in sorted({len(p) for p in prompts}):
        idx = [i for i, p in enumerate(prompts) if len(p) == n]
        for lo in range(0, len(idx), slots):
            part = idx[lo:lo + slots]
            batch = [prompts[i] for i in part]
            batch += [batch[0]] * (slots - len(part))
            ref, margins, _ = static_margins(torch, oracle, batch, max_new)
            for row, i in enumerate(part):
                bad = np.flatnonzero(out[i] != ref[row])
                if bad.size:
                    parted.append((i, int(bad[0]),
                                   float(margins[row, bad[0]])))
    if parted:
        fails.append(f"{tag}: ServeEngine != generate_static: (request, "
                     f"first parting token, the static top-2 margin there) "
                     f"{parted}")
    cap = "" if cfg.moe is None else \
        f", capacity factor {ocfg.moe.capacity_factor} (nothing drops)"
    log(f"[{tag}] ServeEngine (graphed tick) vs generate_static on batches "
        f"of {slots} rows of one prompt length{cap}: equal {not parted}, "
        f"no request dropped {all(len(r.output()) == max_new for r in reqs)}"
        f"; static {time.perf_counter() - t0:.4f} s")
    del oracle
    _free(torch)
    return launches


def moe_rows(torch, seen, launches, suffix, tag):
    """The MoE kernels against their plain versions on inputs ``seen``
    (``capture_kernel_inputs``), rows named ``<kernel>@<suffix>``."""
    rows, shapes = check_kernels(torch, seen, launches)
    for r in rows:
        r["name"] += f"@{suffix}"
    log_kernel_rows(rows, shapes)
    log(f"[{tag}] MoE kernel rows @{suffix}: integer outputs equal, float "
        f"outputs within their tolerance")
    return rows


def moe_targets():
    """The MoE kernels' wrappers, as ``capture_kernel_inputs`` takes them."""
    from repro_torch.kernels.moe_dispatch import ops as dops
    from repro_torch.kernels.moe_gating import ops as gops
    return [(gops, "gating_cuda"), (dops, "dispatch_cuda"),
            (dops, "combine_cuda")]


def phase_olmoe(torch, dev, fails) -> list:
    """olmoe-1b-7b (16 layers, d_model 2048, 16 heads of 128, 64 experts +
    16 spare slots top-8, expert d_ff 1024, vocab 50304 untied), the fused
    gating and dispatch on: serving on 8 slots ≡ generate_static, the
    forward on OLMOE_FWD, the ``moe`` block's forward vs decode, the MoE
    kernels at k 8 over 80 slots at the serve and forward shapes, then
    training at OLMOE_TRAIN's depth with the Reshape loop closed."""
    from repro_torch.configs import get_arch
    tag = "olmoe"
    cfg = fused_moe(get_arch("olmoe-1b-7b"))
    params = model_init(torch, cfg, dev, tag)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in OLMOE_PROMPT_LENS]
    serve_launches = serve_static(torch, dev, tag, cfg, params, prompts,
                                  OLMOE_NEW, len(prompts), fails)
    seen = serve_kernel_inputs(torch, cfg, params, dev, rng)
    rows = moe_rows(torch, seen, serve_launches, "olmoe", tag)
    del seen
    nl = cfg.num_layers
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, OLMOE_FWD), device=dev)
    launches, seen, _ = forward_main(
        torch, tag, cfg, params, {"tokens": toks},
        {"flash_fwd": nl, "moe_gating": nl, "moe_dispatch": nl,
         "moe_combine": nl}, fails, moe_targets())
    rows += moe_rows(torch, seen, launches, "olmoe-fwd", tag)
    del seen, toks
    with torch.no_grad():
        block_decode_check(torch, cfg, params, torch.as_tensor(
            rng.integers(1, cfg.vocab, EQUIV_FWD), device=dev), tag, fails)
    del params
    _free(torch)
    olmoe_train(torch, dev, cfg, fails)
    return rows


def olmoe_train(torch, dev, full, fails) -> None:
    """olmoe-1b-7b cut to OLMOE_TRAIN's layers, trained as ``train_phase``
    trains (``reshape_train_loop``, a warm-up step, ``train_steps``), after
    ``train_compare`` on a cut of its own."""
    tag = "olmoe train"
    tr = OLMOE_TRAIN
    ccfg = cut(full, tr["compare_layers"])
    log(f"[{tag}] train_compare at {ccfg.num_layers} of {full.num_layers} "
        f"layers")
    loop, _ = reshape_train_loop(torch, dev, ccfg, tr["batch"], tr["seq"],
                                 tr["mb"], tag, fails)
    del loop
    _free(torch)
    cfg = cut(full, tr["layers"])
    log(f"[{tag}] the TrainLoop at {cfg.num_layers} of {full.num_layers} "
        f"layers")
    loop, reshaper = reshape_train_loop(torch, dev, cfg, tr["batch"],
                                        tr["seq"], tr["mb"], tag, fails,
                                        compare=False)
    loop.run(1)                                      # warm-up
    train_steps(torch, loop, moe_step_launches(cfg.num_layers, tr["mb"]),
                tr["steps"], tag, fails, reshape_note(reshaper))
    del loop
    _free(torch)


# [ep]: one olmoe-1b-7b MoE layer at full width with its experts over
# EP_WORLD ranks on the one card (each rank a process; a gloo group, since
# NCCL refuses two ranks on one device, carries the CUDA tensors), on the
# forward's 4096 tokens; y against the unsharded layer within the port's
# bf16 MoE tolerance (tests/test_torch_moe.py)
EP_WORLD = 2
EP_TOKENS = OLMOE_FWD[0] * OLMOE_FWD[1]
EP_TOL = 2e-2
# [ep]'s all-to-all layout (moe_ffn_a2a): each rank EP_TOKENS / EP_WORLD of
# the tokens; at this capacity factor nothing drops (cap_s = T_loc k: a
# bucket holds every assignment; cap2 = 1638 and the unsharded capacity
# 1024 rows a slot, against about 512 routed a slot)
EP_A2A_CF = 2.0


def ep_a2a_cfg(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=EP_A2A_CF))


# [ep]'s training steps: build_train_step of paper-moe-100m at full width
# on [train]'s batch (8 x 1024 in 2 microbatches) over each (data, model)
# mesh of the 2 ranks and layout, against the unsharded step on the same
# batch whose microbatches hold the rows that one rank's microbatch holds:
# cuBLAS rounds a product of half the rows otherwise than the whole
# microbatch's, and a router near-tie then routes apart (against the
# 2-microbatch step 90 of 128 expert counts differed on an H100).  The loss is the cross entropy
# alone (no aux or z term): those are statistics of a microbatch group,
# which the sharded step takes over the global microbatch and the
# reference over its own rows (their backward through the collectives is
# held to jax.grad in tests/test_torch_mesh_train.py).  At this capacity
# factor (the experts over top-k) a slot holds every token of its group,
# so nothing can drop.
EP_TRAIN_MESHES = (((2, 1), "tp"), ((1, 2), "tp"), ((1, 2), "dp"))
EP_INTS = ("expert_counts", "slot_counts", "dropped")


def ep_train_cfg():
    cfg = moe_cfg()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def ep_hyper():
    from repro_torch.optim import adamw
    from repro_torch.runtime.train import TrainHyper
    return TrainHyper(opt=adamw.AdamWCfg(**LINEAR_OPT), aux_coef=0.0,
                      z_coef=0.0)


def ep_shards(shape, layout) -> int:
    """The ranks each microbatch's rows are cut over."""
    return shape[0] * shape[1] if layout == "dp" else shape[0]


def ep_train_ref(torch, dev):
    """The unsharded ``build_train_step`` steps that [ep]'s ranks are held
    to, from a seeded state on a seeded batch, one for each number of
    shards in EP_TRAIN_MESHES (TRAIN_MB times it microbatches): the
    state's parameters, the batch, and per shard count the new
    parameters, the metrics and the step's wall."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.runtime.train import build_train_step, make_state
    cfg = ep_train_cfg()
    state = make_state(cfg, torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    tokens = torch.as_tensor(TokenStream(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=SEED).next()["tokens"], device=dev)
    plan = moe_lib.identity_plan(cfg, lm.n_moe_layers(cfg), device=dev)
    out = {"old": state["params"], "tokens": tokens}
    for n in sorted({ep_shards(*m) for m in EP_TRAIN_MESHES}):
        step = build_train_step(
            cfg, step_shape("train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB * n),
            ep_hyper())
        step(state, {"tokens": tokens}, plan.slots, plan.cum)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, metrics = step(state, {"tokens": tokens}, plan.slots,
                            plan.cum)
        torch.cuda.synchronize()
        out[n] = {"new": new["params"], "metrics": metrics,
                  "wall": time.perf_counter() - t0}
    return out


def ep_train(torch, rank, ref) -> list:
    """One rank's [ep] training steps: on each of EP_TRAIN_MESHES, one
    ``build_train_step`` step of its share of the batch and its slots from
    ``ref``'s state (collective bytes and launch counts set to 0 just
    before, read just after), held here against ``ref``'s unsharded step:
    each leaf's change and new value (the rank's slots of an expert leaf),
    the integer metrics; and its replicated leaves against rank 0's (sent
    by a broadcast), bit for bit."""
    import torch.distributed as dist
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.train import (_is_expert, build_train_step,
                                           shard_batch)
    cfg = ep_train_cfg()
    dev = ref["tokens"].device
    plan = moe_lib.identity_plan(cfg, lm.n_moe_layers(cfg), device=dev)
    out = []
    for shape, layout in EP_TRAIN_MESHES:
        mesh = make_mesh(shape, ("data", "model"))
        params = moe_lib.shard_experts(ref["old"], cfg, mesh)
        state = {"params": params, "opt": adamw.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        step = build_train_step(
            cfg, step_shape("train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB),
            ep_hyper(), mesh, layout)
        batch = shard_batch({"tokens": ref["tokens"]}, TRAIN_MB, mesh,
                            layout)
        torch.cuda.synchronize()
        dist.barrier()
        moe_lib.reset_collective_bytes()
        reset_launches()
        t0 = time.perf_counter()
        new, metrics = step(state, batch, plan.slots, plan.cum)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sent, launches = dict(moe_lib.COLLECTIVE_BYTES), dict(LAUNCHES)
        base = ref[ep_shards(shape, layout)]
        want = moe_lib.shard_experts(base["new"], cfg, mesh)
        trip = list(zip(tree_leaves(params), tree_leaves(new["params"]),
                        tree_leaves(want)))
        change, worst = max((_rel_l2(torch, n - o, w - o), name) for name,
                            (o, n, w) in zip(_leaf_names(params), trip))
        value = max(_rel_l2(torch, n, w) for _, n, w in trip)
        ints = {k: int((metrics[k] != base["metrics"][k]).sum())
                for k in EP_INTS}
        replicas = True
        for leaf, expert in zip(tree_leaves(new["params"]),
                                _is_expert(new["params"])):
            if expert and shape[1] > 1:
                continue
            buf = leaf.clone()
            dist.broadcast(buf, 0)
            replicas &= torch.equal(buf, leaf)
        out.append({"mesh": shape, "layout": layout, "wall": wall,
                    "loss": metrics["loss"].item(),
                    "grad_norm": metrics["grad_norm"].item(),
                    "change": change, "worst": worst, "value": value,
                    "ints": ints,
                    "dropped": int(metrics["dropped"].sum()),
                    "replicas": replicas, "bytes": sent,
                    "launches": {k: launches[k] for k in MOE_KERNELS +
                                 ("flash_fwd", "flash_bwd")}})
        del state, new, want, trip, params
        torch.cuda.empty_cache()
    return out


def ep_train_report(torch, res, ref, fails) -> None:
    """[ep]'s training steps against the unsharded steps: the loss averaged
    over the ranks within TRAIN_LOSS_RTOL, each leaf's change within
    TRAIN_GRAD_RTOL (under LINEAR_OPT, its clipped gradient), the integer
    metrics equal, nothing dropped, every rank's replicated leaves equal
    bit for bit; each rank's collective bytes and launches."""
    cfg = ep_train_cfg()
    for n in sorted(k for k in ref if isinstance(k, int)):
        m = ref[n]["metrics"]
        log(f"[ep] unsharded build_train_step of {cfg.name} at full width "
            f"({TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MB * n} microbatches, "
            f"capacity factor {cfg.moe.capacity_factor}, the loss the cross "
            f"entropy alone, AdamW {LINEAR_OPT}): loss "
            f"{m['loss'].item():.7f}, grad_norm {m['grad_norm'].item():.6f}"
            f", dropped {int(m['dropped'].sum())}, {ref[n]['wall']:.4f} s a "
            f"step; {card()}")
    for i, (shape, layout) in enumerate(EP_TRAIN_MESHES):
        n = ep_shards(shape, layout)
        want = ref[n]["metrics"]["loss"].item()
        runs = [r["train"][i] for r in res]
        loss = sum(r["loss"] for r in runs) / len(runs)
        ok = abs(loss - want) <= TRAIN_LOSS_RTOL * abs(want) and all(
            r["change"] <= TRAIN_GRAD_RTOL and not any(r["ints"].values())
            and r["replicas"] and r["dropped"] == 0 and
            all(r["launches"].values()) for r in runs)
        log(f"[ep] build_train_step over data {shape[0]} x model "
            f"{shape[1]}, layout {layout}, a rank's microbatch "
            f"{TRAIN_BATCH // TRAIN_MB // n} x {TRAIN_SEQ}: loss (mean over "
            f"ranks) {loss:.7f} vs the unsharded step's in {TRAIN_MB * n} "
            f"microbatches {want:.7f} (tolerance {TRAIN_LOSS_RTOL} "
            f"relative)")
        for r, o in enumerate(runs):
            log(f"[ep]   rank {r}: worst leaf's change rel L2 "
                f"{o['change']:.4g} ({o['worst']}; tolerance "
                f"{TRAIN_GRAD_RTOL}), new value rel L2 {o['value']:.3g}; "
                f"integer entries that differ {o['ints']}, dropped "
                f"{o['dropped']}; replicated leaves equal rank 0's bit for "
                f"bit {o['replicas']}; grad_norm {o['grad_norm']:.6f}; "
                f"collective bytes {o['bytes']}; launches {o['launches']}; "
                f"{o['wall']:.4f} s (a first step)")
        if not ok:
            fails.append(f"ep: build_train_step over data {shape[0]} x "
                         f"model {shape[1]} ({layout}) differs from the "
                         f"unsharded step")


def bf16_ulp(torch, x):
    """One bf16 ulp at the magnitude of ``x`` (element-wise)."""
    tiny = torch.finfo(torch.bfloat16).tiny
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(
        tiny))) - 7)


def ep_layer(torch, dev, cfg):
    """One MoE layer's router and experts and its input x [1, EP_TOKENS,
    d_model], bf16, drawn on the card from a generator seeded SEED (every
    rank draws the same)."""
    from repro_torch.models import blocks
    from repro_torch.models.params import init_params
    gen = torch.Generator(device=dev).manual_seed(SEED)
    defs = blocks.moe_defs(cfg)
    p = init_params({k: defs[k] for k in ("router", "w_gate", "w_up",
                                          "w_down")},
                    gen, torch.bfloat16, dev)
    x = torch.randn((1, EP_TOKENS, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    return p, x


def ep_rank(rank, world, tmp, train_ref):
    """One rank of [ep] (a process of its own): its slots of the layer,
    ``moe_ffn_sharded`` once to warm up, then once counted (launch counts
    and collective bytes set to 0 just before, read just after), its
    results saved for the parent; rank 0 also keeps the kernels' inputs.
    Then the all-to-all layout, and the training steps of ``ep_train``
    (``train_ref``'s tensors shared with the parent, on the card)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as moe_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        cfg = fused_moe(get_arch("olmoe-1b-7b"))
        p, x = ep_layer(torch, dev, cfg)
        p = {k: v if k == "router" else
             moe_lib.local_experts(v, cfg, mesh).contiguous()
             for k, v in p.items()}
        plan = moe_lib.identity_plan(cfg, 1, device=dev)

        def run():
            return moe_lib.moe_ffn_sharded(p, x, plan.slots[0], plan.cum[0],
                                           cfg, mesh, 0)

        with torch.no_grad():
            run()
            torch.cuda.synchronize()
            dist.barrier()
            reset_launches()
            moe_lib.reset_collective_bytes()
            t0 = time.perf_counter()
            (y, met), seen = capture_kernel_inputs(torch, run, clone=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = {"y": y.cpu(), "metrics": {k: v.cpu() for k, v in met.items()},
               "launches": dict(LAUNCHES), "wall": wall,
               "bytes": dict(moe_lib.COLLECTIVE_BYTES),
               "slots": p["w_gate"].shape[0]}
        if rank == 0:
            out["seen"] = {k: tuple(a.cpu() if torch.is_tensor(a) else a
                                    for a in v) for k, v in seen.items()}
        del seen, y
        # the all-to-all layout: this rank's rows over data x model (its
        # index is its rank on this 1 x EP_WORLD mesh)
        acfg = ep_a2a_cfg(cfg)
        t_loc = EP_TOKENS // world
        xa = x[:, rank * t_loc:(rank + 1) * t_loc]

        def run_a2a():
            return moe_lib.moe_ffn(p, xa, plan.slots[0], plan.cum[0], acfg,
                                   0, mesh=mesh, layout="dp")

        with torch.no_grad():
            run_a2a()
            torch.cuda.synchronize()
            dist.barrier()
            reset_launches()
            moe_lib.reset_collective_bytes()
            t0 = time.perf_counter()
            ya, ma = run_a2a()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out["a2a"] = {"y": ya.cpu(),
                      "metrics": {k: v.cpu() for k, v in ma.items()},
                      "launches": dict(LAUNCHES), "wall": wall,
                      "bytes": dict(moe_lib.COLLECTIVE_BYTES)}
        del p, x, xa, ya, ma
        torch.cuda.empty_cache()
        out["train"] = ep_train(torch, rank, train_ref)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_ep(torch, dev, fails) -> list:
    """[ep]: ``moe_ffn_sharded`` on EP_WORLD ranks (``data`` 1 x ``model``
    EP_WORLD) against the unsharded ``moe_ffn`` on the same card: integer
    metrics equal, y within EP_TOL; each rank's launches (gating, dispatch
    with a ``valid`` mask false on the other rank's slots, combine), the
    bytes it handed to collectives beside the analytic model's, its wall;
    the MoE kernels against their plain versions on rank 0's inputs."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.analysis import flops, roofline
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import NVLINK_BW
    from repro_torch.models import moe as moe_lib
    tag = "ep"
    cfg = fused_moe(get_arch("olmoe-1b-7b"))
    p, x = ep_layer(torch, dev, cfg)
    plan = moe_lib.identity_plan(cfg, 1, device=dev)
    off = torch.zeros(1, dtype=torch.long, device=dev)
    with torch.no_grad():
        moe_lib.moe_ffn(p, x, plan.slots[0], plan.cum[0], cfg, off)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_ref, m_ref = moe_lib.moe_ffn(p, x, plan.slots[0], plan.cum[0], cfg,
                                       off)
        torch.cuda.synchronize()
        wall_ref = time.perf_counter() - t0
        ya_ref, ma_ref = moe_lib.moe_ffn(p, x, plan.slots[0], plan.cum[0],
                                         ep_a2a_cfg(cfg), off)
    del p
    _free(torch)
    train_ref = ep_train_ref(torch, dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(ep_rank, args=(EP_WORLD, tmp, train_ref),
                           nprocs=EP_WORLD, join=True, start_method="spawn")
        res = [torch.load(f"{tmp}/rank{r}.pt") for r in range(EP_WORLD)]
    log(f"[{tag}] {EP_WORLD} ranks (gloo over CUDA tensors, one card) "
        f"started, ran and joined in {time.perf_counter() - t0:.1f} s")
    y = res[0]["y"].to(dev)
    err = (y.float() - y_ref.float()).abs()
    bad = int((err > EP_TOL + EP_TOL * y_ref.float().abs()).sum())
    ints = {k: all(torch.equal(r["metrics"][k].to(dev), m_ref[k])
                   for r in res)
            for k in ("kept_counts", "dropped", "expert_counts")}
    same_y = all(torch.equal(r["y"], res[0]["y"]) for r in res)
    log(f"[{tag}] olmoe-1b-7b MoE layer (d_model {cfg.d_model}, "
        f"{cfg.moe.num_experts} experts + {cfg.moe.spare_slots} spare slots "
        f"top-{cfg.moe.top_k}, expert d_ff {cfg.moe.expert_d_ff}), x "
        f"{list(x.shape)} bf16, data 1 x model {EP_WORLD}, "
        f"{res[0]['slots']} slots a rank: sharded vs unsharded y max |err| "
        f"{err.max().item()}, {int((err > 0).sum())} of {err.numel()} "
        f"elements differ, {bad} beyond atol = rtol = {EP_TOL}; y the same "
        f"on every rank {same_y}; integer metrics equal {ints} (dropped "
        f"{int(m_ref['dropped'][0])}, kept {int(m_ref['kept_counts'].sum())}"
        f" of {EP_TOKENS * cfg.moe.top_k} assignments)")
    if bad or not same_y or not all(ints.values()) or \
            not torch.isfinite(y.float()).all():
        fails.append(f"{tag}: the sharded layer differs from the unsharded "
                     f"one")
    shape = step_shape("prefill", 1, EP_TOKENS)
    m = EP_WORLD
    moe_term = 2 * EP_TOKENS * cfg.moe.top_k * cfg.d_model * flops.BF16 * \
        (m - 1) / m
    one = cut(cfg, 1)
    for r, out in enumerate(res):
        la = out["launches"]
        hit = {k: la[k] for k in MOE_KERNELS}
        handed = out["bytes"]["all_reduce"]
        rl = roofline.analyze(one, shape, {"data": 1, "model": m},
                              hlo_collective_bytes=2 * handed * (m - 1) / m)
        log(f"[{tag}] rank {r}: launches {hit}, wall {out['wall']:.4f} s "
            f"(unsharded {wall_ref:.4f} s); handed to all_reduce {handed} "
            f"B (a ring moves 2 (m-1)/m of it a device: "
            f"{rl.hlo_collective_bytes:.0f} B), to all_gather "
            f"{out['bytes']['all_gather']} B; the analytic model "
            f"(analysis.flops.collective_bytes_per_device, one layer, "
            f"model {m}): {flops.collective_bytes_per_device(one, shape, {'data': 1, 'model': m}):.0f}"
            f" B a device, its MoE term (dispatch and combine all-to-alls "
            f"of bf16 rows) {moe_term:.0f} B; the roofline's collective "
            f"term over NVLink: analytic {rl.collective_s:.4g} s, from the "
            f"measured count {rl.hlo_collective_bytes / NVLINK_BW:.4g} s")
        if not all(hit.values()):
            fails.append(f"{tag}: rank {r} launched {hit}")
    seen = {k: tuple(a.to(dev) if torch.is_tensor(a) else a for a in v)
            for k, v in res[0]["seen"].items()}
    valid = seen["dispatch_cuda"][3]
    log(f"[{tag}] rank 0's dispatch: valid false at "
        f"{int((valid == 0).sum())} of {valid.numel()} assignments (the "
        f"other rank's slots)")
    if not (valid == 0).any():
        fails.append(f"{tag}: the dispatch saw no false valid entry")
    ep_a2a_report(torch, dev, cfg, res, ya_ref, ma_ref, fails)
    ep_train_report(torch, res, train_ref, fails)
    del train_ref
    rows = moe_rows(torch, seen, res[0]["launches"], "ep", tag)
    del res, seen, y, y_ref, x, ya_ref
    _free(torch)
    return rows


def ep_a2a_report(torch, dev, cfg, res, y_ref, m_ref, fails) -> None:
    """[ep]'s all-to-all layout against the unsharded layer at the same
    capacity factor: integer metrics equal, nothing dropped, y within one
    bf16 ulp at the layer output's scale (its largest |y|: an element is a
    weighted sum of k bf16 expert rows, and the experts' GEMMs run on
    buckets of other heights than the unsharded layer's, so a row may
    round to its neighbouring ulp and a sum that cancels keeps that
    error); each rank's launches, the bytes it handed to all_to_all beside
    the analytic a2a term, its wall.  Control: y with the first and the
    last token's rows swapped (each rank's result brought back to the
    other's token, as a misrouted bucket would) must fail that gate."""
    from repro_torch.analysis import flops
    tag, m = "ep", EP_WORLD
    outs = [r["a2a"] for r in res]
    y = torch.cat([o["y"] for o in outs], 1).to(dev)
    err = (y.float() - y_ref.float()).abs()
    scale_ulp = bf16_ulp(torch, y_ref.float().abs().max()).item()
    own = err / bf16_ulp(torch, y_ref)
    wrong = y.clone()
    wrong[:, [0, -1]] = y[:, [-1, 0]]
    ctl = (wrong.float() - y_ref.float()).abs().max().item()
    ints = {k: all(torch.equal(o["metrics"][k].to(dev), m_ref[k])
                   for o in outs)
            for k in ("kept_counts", "dropped", "expert_counts")}
    dropped = [int(o["metrics"]["dropped"][0]) for o in outs]
    log(f"[{tag}] all-to-all layout (moe_ffn_a2a, layout \"dp\"): "
        f"{EP_TOKENS // m} tokens a rank over data 1 x model {m}, capacity "
        f"factor {EP_A2A_CF}: vs the unsharded layer y max |err| "
        f"{err.max().item()} (tolerance one bf16 ulp at max |y| "
        f"{y_ref.float().abs().max().item():.4g}: {scale_ulp}), "
        f"{int((err > 0).sum())} of {err.numel()} elements differ, "
        f"{int((own > 1).sum())} by more than one ulp of their own "
        f"magnitude; "
        f"integer metrics equal {ints} (dropped {dropped}, unsharded "
        f"{int(m_ref['dropped'][0])}); gloo carried the CUDA tensors; "
        f"control, two tokens' rows swapped: max |err| {ctl}")
    if err.max().item() > scale_ulp or not all(ints.values()) or \
            any(dropped) or not torch.isfinite(y.float()).all():
        fails.append(f"{tag}: the all-to-all layer differs from the "
                     f"unsharded one")
    if ctl <= scale_ulp:
        fails.append(f"{tag}: the all-to-all gate passes y with two tokens' "
                     f"rows swapped")
    toks_dev = EP_TOKENS / m
    analytic = 2 * toks_dev * cfg.moe.top_k * cfg.d_model * flops.BF16 * \
        (m - 1) / m
    for r, o in enumerate(outs):
        hit = {k: o["launches"][k] for k in MOE_KERNELS}
        handed = o["bytes"]["all_to_all"]
        log(f"[{tag}] a2a rank {r}: launches {hit}, wall {o['wall']:.4f} "
            f"s; handed to all_to_all {handed} B (x and y buckets "
            f"[{m}, cap_s, D] bf16, and their slot ids), of which "
            f"{handed * (m - 1) // m} B leave the rank; the analytic a2a "
            f"term (analysis.flops.collective_bytes_per_device, layout "
            f"\"dp\": dispatch and combine of T_loc k bf16 rows, one layer) "
            f"{analytic:.0f} B a device (the buckets are padded to cap_s = "
            f"T_loc k cf / m rows a destination); to all_reduce "
            f"{o['bytes']['all_reduce']} B")
        if hit != {"moe_gating": 1, "moe_dispatch": 2, "moe_combine": 2}:
            fails.append(f"{tag}: a2a rank {r} launched {hit}")


def phase_qwen3moe(torch, dev, fails) -> list:
    """qwen3-moe-235b-a22b cut to QWEN3_LAYERS layers (d_model 4096, 64
    query heads of 128 over 4 KV heads, 128 experts + 16 spare slots
    top-8, expert d_ff 1536, vocab 151936 untied), fused gating and
    dispatch: the forward (``gating_kernel<32, 4>``, dispatch and combine
    over 144 slots at D 4096), the MoE kernels at the forward and serve
    shapes, and serving on 4 slots ≡ generate_static."""
    from repro_torch.configs import get_arch
    tag = "qwen3moe"
    cfg = cut(fused_moe(get_arch("qwen3-moe-235b-a22b")), QWEN3_LAYERS)
    params = model_init(torch, cfg, dev, tag)
    wq, wo = params["moe"]["wq"], params["moe"]["wo"]
    if tuple(wo.shape[1:]) != (8192, 4096) or wq.shape[-1] != 8192:
        fails.append(f"{tag}: wq {tuple(wq.shape)}, wo {tuple(wo.shape)}")
    rng = np.random.default_rng(SEED)
    nl = cfg.num_layers
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, QWEN3_FWD), device=dev)
    from repro_torch.kernels.flash_attention import flash_attention as fa
    launches, seen, _ = forward_main(
        torch, tag, cfg, params, {"tokens": toks},
        {"flash_fwd": nl, "moe_gating": nl, "moe_dispatch": nl,
         "moe_combine": nl}, fails,
        moe_targets() + [(fa, "flash_fwd_cuda")])
    q, k = seen.pop("flash_fwd_cuda")[:2]
    log(f"[{tag}] the flash kernel sees q {list(q.shape)}, k {list(k.shape)} "
        f"(KV heads repeated {cfg.n_heads // cfg.n_kv_heads}x), hd "
        f"{q.shape[-1]}")
    if q.shape[-1] != 128 or q.shape[2] != 64:
        fails.append(f"{tag}: flash saw q {tuple(q.shape)}")
    del q, k
    rows = moe_rows(torch, seen, launches, "qwen3-fwd", tag)
    del seen, toks
    prompts = list(rng.integers(1, cfg.vocab, QWEN3_PROMPT).astype(np.int32))
    serve_launches = serve_static(torch, dev, tag, cfg, params, prompts,
                                  QWEN3_NEW, len(prompts), fails)
    rows += moe_rows(torch, serve_kernel_inputs(torch, cfg, params, dev, rng,
                                                len(prompts)),
                     serve_launches, "qwen3", tag)
    del params
    _free(torch)
    return rows


def phase_dense(torch, dev, fails) -> None:
    """starcoder2-7b, yi-34b and command-r-plus-104b at DENSE's depths: each
    forward on DENSE_FWD (one flash launch a layer) and serving on 2 slots
    ≡ generate_static."""
    from repro_torch.configs import get_arch
    for arch, layers in DENSE:
        tag = f"dense {arch}"
        full = get_arch(arch)
        cfg = cut(full, layers)
        log(f"[{tag}] depth {cfg.num_layers} of {full.num_layers}")
        params = model_init(torch, cfg, dev, tag)
        rng = np.random.default_rng(SEED)
        toks = torch.as_tensor(rng.integers(1, cfg.vocab, DENSE_FWD),
                               device=dev)
        forward_main(torch, tag, cfg, params, {"tokens": toks},
                     {"flash_fwd": cfg.num_layers}, fails)
        del toks
        prompts = list(rng.integers(1, cfg.vocab, DENSE_PROMPT)
                       .astype(np.int32))
        serve_static(torch, dev, tag, cfg, params, prompts, DENSE_NEW,
                     len(prompts), fails)
        del params
        _free(torch)


def vision_positions3(torch, b, gh, gw, n_text, dev):
    """[b, gh·gw + n_text, 3] M-RoPE ids: a gh × gw patch grid (t 0, h its
    row, w its column), then text whose three ids count on from the grid's
    largest extent."""
    i = torch.arange(gh * gw, device=dev)
    grid = torch.stack([torch.zeros_like(i), i // gw, i % gw], -1)
    text = (max(gh, gw) + torch.arange(n_text, device=dev))[:, None] \
        .expand(n_text, 3)
    return torch.cat([grid, text])[None].expand(b, -1, 3).contiguous()


def phase_qwen2vl(torch, dev, fails) -> None:
    """qwen2-vl-7b at full depth (28 layers, d_model 3584, 28 heads of 128
    over 4 KV heads, d_ff 18944, vocab 152064, M-RoPE): the forward on
    QWEN2VL_FWD with a patch grid's (t, h, w) ids, against the same forward
    through the plain versions (argmax equal wherever the plain top-2
    margin exceeds twice GEMMA_ATOL), and serving on 4 slots ≡
    generate_static."""
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    tag = "qwen2vl"
    cfg = get_arch("qwen2-vl-7b")
    params = model_init(torch, cfg, dev, tag)
    rng = np.random.default_rng(SEED)
    b, s = QWEN2VL_FWD
    gh, gw = QWEN2VL_GRID
    batch = {"tokens": torch.as_tensor(rng.integers(1, cfg.vocab, (b, s)),
                                       device=dev),
             "positions3": vision_positions3(torch, b, gh, gw, s - gh * gw,
                                             dev)}
    forward_main(torch, tag, cfg, params, batch,
                 {"flash_fwd": cfg.num_layers}, fails)
    with torch.no_grad():
        got = lm.forward(params, batch, cfg)[0]
        plain = lm.forward(params, batch, cfg, impl="torch")[0]
        flat = lm.forward(params, {"tokens": batch["tokens"]}, cfg)[0]
    top2 = plain.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * GEMMA_ATOL
    differ = got.argmax(-1) != plain.argmax(-1)
    log(f"[{tag}] forward with positions3 (a {gh} x {gw} grid, then "
        f"{s - gh * gw} text positions), kernels vs plain versions: max "
        f"|logit diff| {(got - plain).abs().max().item()} (max |logit| "
        f"{plain.abs().max().item()}), rel L2 {_rel_l2(torch, got, plain):.4g}"
        f"; argmax equal at {int((~differ).sum())} of {differ.numel()}, "
        f"{int((sure & differ).sum())} differ of the {int(sure.sum())} whose "
        f"plain top-2 margin exceeds {2 * GEMMA_ATOL}; without positions3 "
        f"the logits move by {(flat - got).abs().max().item()}")
    if (sure & differ).any() or not torch.isfinite(got).all():
        fails.append(f"{tag}: the kernels' forward differs from the plain "
                     f"one")
    if torch.equal(flat, got):
        fails.append(f"{tag}: positions3 changed nothing")
    del got, plain, flat, batch
    prompts = list(rng.integers(1, cfg.vocab, QWEN3_PROMPT).astype(np.int32))
    serve_static(torch, dev, tag, cfg, params, prompts, QWEN3_NEW,
                 len(prompts), fails)
    del params
    _free(torch)


def shape_counts(torch, run, module, name, key):
    """Run ``run()`` with ``module.name`` wrapped to count its calls by
    ``key(args)``.  Returns (``run()``'s result, {key: calls})."""
    counts = {}
    orig = getattr(module, name)

    def counted(*args, **kw):
        k = key(args)
        counts[k] = counts.get(k, 0) + 1
        return orig(*args, **kw)

    setattr(module, name, counted)
    try:
        return run(), counts
    finally:
        setattr(module, name, orig)


def whisper_flash_rows(torch, tag, cases, fwd_counts, bwd_counts) -> list:
    """The flash kernels on each captured case ((name, q, k, v), not
    causal) against their plain version, forward and backward, timed by
    graph replay beside ``scaled_dot_product_attention`` and aten's flash
    backward (``is_causal=False``).  Returns the JSON rows."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_bwd_cuda, flash_fwd_cuda)
    from repro_torch.models.attention import chunked_attention
    gen = torch.Generator(device=cases[0][1].device).manual_seed(SEED)
    rows = []
    for case, q, k, v in cases:
        do = torch.randn(q.shape, generator=gen, device=q.device) \
            .to(torch.bfloat16)
        _, o32, lse, errs, po, ps = flash_check(
            torch, tag, f"{case}, on the forward's inputs", q, k, v, do,
            causal=False)
        b, sq, h, hd = q.shape
        sk = k.shape[1]
        qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        with torch.no_grad():
            fwd = dict(
                ms=graph_ms(torch, lambda: flash_fwd_cuda(q, k, v, False),
                            reps=10),
                plain_ms=graph_ms(torch, lambda: chunked_attention(
                    q, k, v, causal=False), reps=10),
                library_ms=graph_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        qh, kh, vh), reps=10))
            bwd = dict(
                ms=graph_ms(torch, lambda: flash_bwd_cuda(
                    q, k, v, o32, lse, do, False), reps=10),
                library_ms=graph_ms(torch, sdpa_backward(
                    torch, qh, kh, vh, doh, causal=False), reps=10))
        bwd["plain_ms"] = event_ms(torch, lambda: torch.autograd.grad(
            po, ps, do, retain_graph=True))
        for name, back, err, t, n in (
                ("flash_fwd", False, errs["o"], fwd, fwd_counts[case]),
                ("flash_bwd", True, max(errs["dq"], errs["dk"], errs["dv"]),
                 bwd, bwd_counts[case])):
            b_ms, b_by = flash_bound(b, sq, h, hd, 2, back, sk=sk,
                                     causal=False)
            rows.append(dict(
                name=f"{name}@whisper-{case}", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention/"
                         "flash_attention.py:58",
                launches=n, max_abs_err=err, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                library_ms=t["library_ms"]))
            lib = "aten flash backward" if back else \
                "scaled_dot_product_attention"
            log(f"[{tag}] {name} {case} q {[b, sq, h, hd]}, k {[b, sk, h, hd]}"
                f", not causal: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f} "
                f"ms, {lib} {t['library_ms']:.4f} ms, bound {b_ms:.5f} ms by "
                f"{b_by}; by CUDA-graph replay but the plain backward); "
                f"launches on its path {n}")
        del do, o32, lse, po, ps, qh, kh, vh, doh
        _free(torch)
    return rows


def phase_whisper(torch, dev, fails) -> list:
    """whisper-base at full depth (6 encoder and 6 decoder layers, d_model
    512, 8 heads of 64, d_ff 2048, tied vocab 51865; no rotary): ``encode``
    on [WHISPER_B, 1500, 512] frames, ``lm.forward`` on WHISPER_SEQ tokens
    (18 flash launches: 6 bidirectional encoder layers, 6 causal decoder
    self-attentions, 6 cross-attentions over the 1500 frames), step-by-step
    ``decode_step`` against the precomputed cross K/V vs the forward, the
    non-causal flash kernels on the encoder's and the cross-attention's
    inputs, then training: one microbatch through the kernels vs the plain
    versions, and TrainLoop steps, each step's launches checked."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import blocks, lm
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.loop import LoopConfig, TrainLoop
    from repro_torch.runtime.train import TrainHyper, build_grad_step
    tag = "whisper"
    cfg = get_arch("whisper-base")
    params = model_init(torch, cfg, dev, tag)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    b, s, se = WHISPER_B, WHISPER_SEQ, cfg.enc_seq
    frames = (0.1 * torch.randn((b, se, cfg.d_model), generator=gen,
                                device=dev)).to(torch.bfloat16)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (b, s)), device=dev)
    nl, ne = cfg.num_layers, cfg.enc_layers

    def kind(args):
        sq, sk = args[0].shape[1], args[1].shape[1]
        return "enc" if sq == sk == se else "cross" if sk == se else "self"

    with torch.no_grad():
        lm.encode(params, frames, cfg)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc, seen = capture_kernel_inputs(
            torch, lambda: lm.encode(params, frames, cfg),
            [(fa, "flash_fwd_cuda")], clone=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if LAUNCHES["flash_fwd"] != ne or \
                not torch.isfinite(enc.float()).all():
            fails.append(f"{tag}: encode launched {LAUNCHES['flash_fwd']} "
                         f"flash_fwd, expected {ne}")
        log(f"[{tag}] encode {[b, se, cfg.d_model]} frames: {wall:.4f} s, "
            f"{b * se / wall:.1f} frames/s, launches {_nonzero(LAUNCHES)}")
        enc_case = seen["flash_fwd_cuda"]
        batch = {"tokens": toks, "frames": frames}
        _, seen, fwd_counts = forward_main(
            torch, tag, cfg, params, batch, {"flash_fwd": ne + 2 * nl},
            fails, [(fa, "flash_fwd_cuda")], (fa, "flash_fwd_cuda", kind))
        cross_case = seen["flash_fwd_cuda"]
        for case, args, sq in (("enc", enc_case, se),
                               ("cross", cross_case, s)):
            q, k, _, causal = args[:4]
            if (q.shape[1], k.shape[1], causal) != (sq, se, False):
                fails.append(f"{tag}: the {case} flash call saw q "
                             f"{tuple(q.shape)}, k {tuple(k.shape)}, causal "
                             f"{causal}")
        if fwd_counts != {"enc": ne, "self": nl, "cross": nl}:
            fails.append(f"{tag}: flash calls by kind {fwd_counts}")
        enc_case, cross_case = enc_case[:3], cross_case[:3]
        del seen
        # decode against the precomputed cross K/V, every step's logits
        # against the forward's; then two faults the check must catch on
        # the first WHISPER_CONTROL_STEPS steps: the cross K/V left at zero
        # (what the reference's engine serves) and each layer given the
        # next layer's
        fwd = lm.forward(params, batch, cfg)[0]

        def decode(src, n):
            state = lm.init_cache(cfg, b, s, device=dev)
            c = state["caches"]["dec"]
            for li in range(nl):
                if src(li) is None:
                    continue
                ck, cv = blocks.cross_kv(cfg, {
                    name: w[src(li)] for name, w in params["dec"].items()},
                    enc)
                c["ck"][li].copy_(ck)
                c["cv"][li].copy_(cv)
            out = []
            for i in range(n):
                lg, state = lm.decode_step(params, state, toks[:, i:i + 1],
                                           cfg)
                out.append(lg)
            return torch.stack(out, 1)

        def held(dec, ref):
            diff = (dec - ref).abs()
            return (bool((diff <= WHISPER_ATOL + WHISPER_RTOL * ref.abs())
                         .all()), diff.max().item(), _rel_l2(torch, dec, ref))

        t0 = time.perf_counter()
        dec = decode(lambda li: li, s)
        t_dec = time.perf_counter() - t0
        ok, worst, rel = held(dec, fwd)
        log(f"[{tag}] decode_step with the precomputed cross K/V vs the "
            f"forward on {[b, s]}: max |logit diff| {worst} (max |logit| "
            f"{fwd.abs().max().item()}, mean |logit| "
            f"{fwd.abs().mean().item()}), rel L2 {rel:.4g}, within atol "
            f"{WHISPER_ATOL} + rtol {WHISPER_RTOL}: {ok}; argmax equal at "
            f"{int((dec.argmax(-1) == fwd.argmax(-1)).sum())} of {b * s}; "
            f"{s} steps {t_dec:.4f} s")
        if not ok:
            fails.append(f"{tag}: decode with cross K/V does not reproduce "
                         f"the forward")
        n = WHISPER_CONTROL_STEPS
        for fault, src in (("zero cross K/V", lambda li: None),
                           ("each layer the next layer's cross K/V",
                            lambda li: (li + 1) % nl)):
            bad = decode(src, n)
            caught, worst, rel = held(bad, fwd[:, :n])
            caught = not caught
            log(f"[{tag}] control, {fault}, first {n} steps: max |logit "
                f"diff| {worst}, rel L2 {rel:.4g}, argmax equal at "
                f"{int((bad.argmax(-1) == fwd[:, :n].argmax(-1)).sum())} "
                f"of {b * n}; the check catches it: {caught}")
            if not caught:
                fails.append(f"{tag}: the decode check passes with "
                             f"{fault}")
            del bad
        del fwd, dec, enc
    del frames, toks
    _free(torch)

    # training: zero frames, as the loop feeds them
    tr = WHISPER_TRAIN
    n_mb, mb = tr["mb"], tr["batch"] // tr["mb"]

    def stream():
        return TokenStream(vocab=cfg.vocab, seq_len=tr["seq"],
                           global_batch=tr["batch"], seed=SEED)

    hyper = TrainHyper()
    loop = TrainLoop(cfg, stream(), hyper,
                     LoopConfig(microbatches=n_mb, device=str(dev)),
                     seed=SEED)
    first = {"tokens": torch.as_tensor(stream().next()["tokens"][:mb],
                                       device=dev),
             "frames": torch.zeros((mb, se, cfg.d_model), device=dev)}
    res = {impl: build_grad_step(cfg, hyper, impl)[0](
        loop.state["params"], first, None, None, 0)
        for impl in ("auto", "torch")}
    (gk, mk), (gp, mp) = res["auto"], res["torch"]
    loss_k, loss_p = mk["loss"].item(), mp["loss"].item()
    worst = max(_rel_l2(torch, a, c) for a, c in
                zip(tree_leaves(gk), tree_leaves(gp)))
    log(f"[{tag}] train: one microbatch {list(first['tokens'].shape)} with "
        f"zero frames, kernels vs plain versions: loss {loss_k:.7f} vs "
        f"{loss_p:.7f} (rel {abs(loss_k - loss_p) / loss_p:.3g}, tolerance "
        f"{TRAIN_LOSS_RTOL}); gradient leaves worst rel L2 {worst:.4g} "
        f"(tolerance {TRAIN_GRAD_RTOL})")
    if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * loss_p or \
            worst > TRAIN_GRAD_RTOL:
        fails.append(f"{tag}: the kernel training step differs from the "
                     f"plain one")
    del res, gk, mk, gp, mp, first
    _free(torch)
    loop.run(1)                                     # warm-up
    per_step = {"flash_fwd": (ne + 2 * nl) * n_mb,
                "flash_bwd": (ne + 2 * nl) * n_mb}
    _, bwd_counts = shape_counts(
        torch, lambda: train_steps(torch, loop, per_step, tr["steps"],
                                   f"{tag} train", fails),
        fa, "flash_bwd_cuda", kind)
    log(f"[{tag}] train: flash_bwd launches by kind {bwd_counts}")
    del loop
    _free(torch)
    rows = whisper_flash_rows(
        torch, tag, [("enc", *enc_case), ("cross", *cross_case)],
        fwd_counts, bwd_counts)
    del params
    _free(torch)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {built} in {time.perf_counter() - t0:.2f} s")
    build_report(build)

    fails = []
    t_all = t_phase = time.perf_counter()

    def phase_time(name):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"[time] {name}: {now - t_phase:.1f} s (run so far "
            f"{now - t_all:.1f} s)")
        t_phase = now

    rows, serve_launches = moe_phase(torch, dev, fails)
    _free(torch)
    phase_time("serve, graph, kernel, equiv")
    rows += serve_features_phase(torch, dev, fails, phase_time)
    _free(torch)
    train_rows, train_launches = train_phase(torch, dev, fails)
    phase_time("train")
    flash_rows = flash_phase(torch, dev, train_launches)
    rows += flash_rows + train_rows
    phase_time("flash")
    _free(torch)
    rows += decode_attn_phase(torch, dev, fails,
                              serve_launches["decode_attn"])
    phase_time("decode_attn")
    _free(torch)
    control_phase(torch, dev, fails)
    phase_time("control")
    for ph, tr in zip(SSM_PHASES, SSM_TRAIN):
        _free(torch)
        row, launches = ssm_phase(torch, dev, ph, fails)
        rows.append(row)
        for r in flash_rows:
            if r["name"] == f"flash_fwd@{ph['tag']}":
                r["launches"] = launches["flash_fwd"]
        phase_time(ph["tag"])
        _free(torch)
        rows += ssm_train(torch, dev, tr, fails)
        phase_time(tr["tag"])
    for name, fn in (("gemma3", gemma3_phase), ("olmoe", phase_olmoe),
                     ("ep", phase_ep),
                     ("qwen3moe", phase_qwen3moe), ("dense", phase_dense),
                     ("qwen2vl", phase_qwen2vl), ("whisper", phase_whisper)):
        _free(torch)
        rows += fn(torch, dev, fails) or []
        phase_time(name)
    if fails:
        raise AssertionError("; ".join(fails))

    print(json.dumps({"kernels": rows}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
