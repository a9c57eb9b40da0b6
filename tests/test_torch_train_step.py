"""The port's production step, ``build_train_step`` at ``mesh=None``,
against the JAX package's (jitted), from the reference's own state
(``bridge.state_from_jax``) on the same tokens.

Configs: ``olmoe-1b-7b-smoke`` with the fused gating and dispatch (the
reference's dispatch through its Pallas kernels in interpret mode, and the
training-parity inputs of ``tests/test_torch_train.py``, on which both
route alike), ``gemma3-1b-smoke`` (``local``/``attn``) and
``whisper-base-smoke`` (encoder-decoder, frames in the batch), each 8 x 32
tokens in 2 microbatches; the dense configs take the placeholder plan of
``tests/test_archs_smoke.py``.

Both frameworks run in f32 (their casts to bf16 keep f32, the
``compute`` fixture of ``tests/test_torch_ssm_train.py``), where the
comparison of every leaf is meaningful: the loss (the microbatches' mean)
within 1e-5 relative, the gradient norm within 1e-3 relative, the integer
metrics (summed over microbatches) equal, and each parameter's change
within 1e-3 relative L2 (sums in other orders).  AdamW runs with lr 1e3,
eps 1e3 and no weight decay, so a change is the clipped gradient itself
(gradients sit far below eps; with the default settings the first step
moves every parameter by lr times the gradient's sign, and an element near
zero may move either way).  The step's counter and its schedule's lr are
equal too.  In the models' bf16 the loss is held within 1e-3 relative
(``tests/test_torch_ssm_train.py``'s bf16 bound): bf16 router near-ties
route a few tokens otherwise in the two frameworks (ROADMAP, queue 3).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.data.synthetic import TokenStream as JTokenStream
from repro.models import moe as j_moe
from repro.optim import adamw as j_adamw
from repro.runtime import train as j_train
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCfg
from repro_torch.models import bridge
from repro_torch.models import moe
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import train
from test_torch_ssm_train import compute  # noqa: F401
from test_torch_train import pallas_dispatch  # noqa: F401

ARCHS = ("olmoe-1b-7b-smoke", "gemma3-1b-smoke", "whisper-base-smoke")
SEQ, BATCH, N_MB, SEED, ALPHA = 32, 8, 2, 5, 2.0
OPT = dict(lr=1e3, eps=1e3, weight_decay=0.0, warmup_steps=1)
LOSS_RTOL = {"f32": 1e-5, "bf16": 1e-3}
NORM_RTOL, GRAD_RTOL = 1e-3, 1e-3
INTS = ("expert_counts", "slot_counts", "dropped")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fused(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, fused_gating=True, fused_dispatch=True))


def run_both(arch, remat="none"):
    """One step of each framework's ``build_train_step`` from the
    reference's initial state: (the reference's old params, new params and
    metrics as numpy; the port's new state and metrics)."""
    cj, ct = _fused(j_get_arch(arch)), _fused(get_arch(arch))
    state = jax.jit(j_train.make_state, static_argnums=0)(
        cj, jax.random.PRNGKey(0))
    tokens = JTokenStream(vocab=cj.vocab, seq_len=SEQ, global_batch=BATCH,
                          seed=SEED, class_alpha=ALPHA).next()["tokens"]
    batch = {"tokens": tokens}
    if cj.enc_layers:
        batch["frames"] = np.random.default_rng(SEED).standard_normal(
            (BATCH, cj.enc_seq, cj.d_model)).astype(np.float32)
    nl = j_train.lm.n_moe_layers(cj)
    if nl:
        jp = j_moe.identity_plan(cj, nl)
        ps, pc = np.asarray(jp.slots), np.asarray(jp.cum)
    else:
        ps = np.zeros((1, 1, 1), np.int32)
        pc = np.ones((1, 1, 1), np.float32)
    jstep = j_train.build_train_step(
        cj, JShapeCfg("t", SEQ, BATCH, "train", N_MB),
        j_train.TrainHyper(opt=j_adamw.AdamWCfg(**OPT), remat=remat))
    jnew, jm = jax.jit(jstep)(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                              jnp.asarray(ps), jnp.asarray(pc))
    tstate = bridge.state_from_jax(jax.tree.map(np.asarray, state), "cpu")
    tstep = train.build_train_step(
        ct, ShapeCfg("t", SEQ, BATCH, "train", N_MB),
        train.TrainHyper(opt=adamw.AdamWCfg(**OPT), remat=remat))
    tnew, tm = tstep(tstate, {k: torch.from_numpy(np.asarray(v))
                              for k, v in batch.items()},
                     torch.from_numpy(np.array(ps)).long(),
                     torch.from_numpy(np.array(pc)))
    ref = (jax.tree.map(np.asarray, state["params"]),
           jax.tree.map(np.asarray, jnew), jax.tree.map(np.asarray, jm))
    return ref, (tnew, tm)


def check(ref, port, compute):
    """The module docstring's gates."""
    old, jnew, jm = ref
    tnew, tm = port
    loss, want = float(tm["loss"]), float(jm["loss"])
    assert abs(loss - want) < LOSS_RTOL[compute] * want, (loss, want)
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    if compute == "bf16":
        return
    gn, jgn = float(tm["grad_norm"]), float(jm["grad_norm"])
    assert abs(gn - jgn) < NORM_RTOL * jgn, (gn, jgn)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    for key in INTS:
        if key in jm:
            np.testing.assert_array_equal(tm[key].numpy(), jm[key])
    for a, b, o in zip(tree_leaves(tnew["params"]),
                       jax.tree.leaves(jnew["params"]), jax.tree.leaves(old)):
        want = b - o
        got = a.numpy() - o
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err < GRAD_RTOL, err


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, compute, pallas_dispatch):
    ref, port = run_both(arch)
    check(ref, port, compute)
    # metrics: integers summed over the microbatches (in their own dtype),
    # floats averaged
    for key in INTS:
        if key in port[1]:
            assert not port[1][key].is_floating_point()
    assert port[1]["loss"].shape == ()


def test_train_step_takes_the_plan():
    """A MoE step routes by the plan it is given: a plan that moves expert
    0 to a spare slot sends the first layer's expert-0 tokens there (the
    spare's weights differ, so later layers route otherwise)."""
    cfg = _fused(get_arch("paper-moe-100m-smoke"))
    state = train.make_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (4, 16)))
    step = train.build_train_step(cfg, ShapeCfg("t", 16, 4, "train", 2),
                                  train.TrainHyper())
    nl = cfg.num_layers
    plan = moe.identity_plan(cfg, nl, device="cpu")
    moved = plan.slots.clone()
    moved[:, 0, :] = cfg.moe.num_experts          # the first spare slot
    _, m0 = step(state, {"tokens": tokens}, plan.slots, plan.cum)
    _, m1 = step(state, {"tokens": tokens}, moved, plan.cum)
    e = cfg.moe.num_experts
    assert int(m1["slot_counts"][0, e]) == int(m0["slot_counts"][0, 0]) > 0
    assert int(m1["slot_counts"][:, 0].sum()) == 0
