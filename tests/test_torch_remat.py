"""Activation recompute in the training step (``TrainHyper.remat``,
``lm.forward(remat=...)``).

* A step under ``"full"`` and under ``"dots"`` is bit-equal to the step
  under ``"none"`` from the same state and batch (the recompute runs the
  same deterministic operations), on the fused and on the granulated path,
  and granulated ≡ fused under each policy; the MoE metrics keep one entry
  a layer (a recompute adds none).  Configs: the MoE, recurrent,
  hybrid, ``local``/``attn`` and encoder-decoder smoke models.
* The production step under each policy against the JAX package's
  ``build_train_step(..., TrainHyper(remat=...))`` on ``gemma3-1b-smoke``,
  with ``tests/test_torch_train_step.py``'s inputs and gates.  The JAX
  package cannot remat a MoE stack: its ``moe_body`` reads the metrics
  list that the checkpointed block fills (``src/repro/models/lm.py``,
  ``_run_stack``), so a tracer leaks out of ``jax.checkpoint``; a MoE
  model's remat steps are held to the port's own ``"none"`` step above.
* The dry run's traced live bytes fall from ``"none"`` to ``"dots"`` and
  ``"full"`` (``launch.dryrun.trace_step`` on ``meta``, where the
  kernels' stand-ins run in the recompute too).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import train
from test_torch_train_step import (check, compute,  # noqa: F401
                                   pallas_dispatch, run_both)

ARCHS = ("paper-moe-100m-smoke", "rwkv6-1.6b-smoke", "zamba2-7b-smoke",
         "gemma3-1b-smoke", "whisper-base-smoke")
POLICIES = ("full", "dots")
BATCH, SEQ, N_MB = 4, 16, 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    cfg = get_arch(arch)
    state = train.make_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(1, cfg.vocab,
                                                     (BATCH, SEQ)))}
    if cfg.enc_layers:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    nl = lm.n_moe_layers(cfg)
    plan = moe_lib.identity_plan(cfg, nl, device="cpu") if nl else None
    return cfg, state, batch, ((plan.slots, plan.cum) if plan else
                               (None, None))


def _fused(cfg, remat, state, batch, plan):
    new, metrics, opt_m = train.build_fused_step(
        cfg, train.TrainHyper(remat=remat))(state, batch, *plan, 1.0, N_MB)
    return new["params"], metrics, opt_m


def _granulated(cfg, remat, state, batch, plan):
    grad_mb, apply, _ = train.build_grad_step(
        cfg, train.TrainHyper(remat=remat))
    mb, seq = BATCH // N_MB, batch["tokens"].shape[1]
    acc, metrics = None, []
    for i in range(N_MB):
        g, m = grad_mb(state["params"],
                       {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()},
                       *plan, i * mb * seq)
        acc = g if acc is None else tree_map(lambda a, b: a + b, acc, g)
        metrics.append(m)
    new, _ = apply(state, acc, N_MB, 1.0)
    return new["params"], {k: torch.stack([m[k] for m in metrics])
                           for k in metrics[0]}


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


@pytest.mark.parametrize("remat", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_step_bit_equal(arch, remat):
    cfg, state, batch, plan = _setup(arch)
    p0, m0, o0 = _fused(cfg, "none", state, batch, plan)
    p1, m1, o1 = _fused(cfg, remat, state, batch, plan)
    assert _bit_equal(p1, p0)
    assert m1.keys() == m0.keys()
    for k in m0:
        assert torch.equal(m1[k], m0[k]), k
    assert torch.equal(o1["grad_norm"], o0["grad_norm"])
    nl = lm.n_moe_layers(cfg)
    if nl:
        assert m1["expert_counts"].shape == (N_MB, nl, cfg.moe.num_experts)
        assert m1["dropped"].shape == (N_MB, nl)
    pg, mg = _granulated(cfg, remat, state, batch, plan)
    assert _bit_equal(pg, p1)
    for k in mg:
        assert torch.equal(mg[k], m1[k]), k


def test_unknown_policy_raises():
    cfg, state, batch, plan = _setup("gemma3-1b-smoke")
    with pytest.raises(ValueError, match="remat"):
        _fused(cfg, "some", state, batch, plan)


@pytest.mark.parametrize("remat", POLICIES)
def test_remat_train_step_matches_reference(remat, compute,
                                            pallas_dispatch):
    ref, port = run_both("gemma3-1b-smoke", remat)
    check(ref, port, compute)


@pytest.mark.parametrize("arch", ("paper-moe-100m-smoke", "zamba2-7b-smoke"))
def test_dryrun_live_bytes_fall(arch):
    cfg = get_arch(arch)
    shape = ShapeCfg("t", 64, 4, "train", 2)
    live = {r: dryrun.trace_step(cfg, shape, r)["transient"]
            for r in ("none", "dots", "full")}
    assert live["full"] < live["none"], live
    assert live["full"] <= live["dots"] <= live["none"], live
    recs = dryrun.dry_cell(cfg, shape, [dryrun.SH.parse_mesh("1x1")],
                           "full")
    assert recs[0]["remat"] == "full"
    assert recs[0]["step_flops"]["hlo"] > dryrun.dry_cell(
        cfg, shape, [dryrun.SH.parse_mesh("1x1")])[0]["step_flops"]["hlo"]
