"""How far a bf16 training step's gradients are from the same step in
high precision, for the port and for the JAX package, on the recurrent
smoke models with the reference's own weights.

For ``rwkv6-1.6b-smoke`` and ``zamba2-7b-smoke`` (the reference's weights
from ``PRNGKey(0)``, one microbatch of 2 x 32 tokens, the reference's
exact RWKV6 scan) this prints the loss of the port's and the reference's
bf16 step, then the three worst gradient leaves' relative L2 distance of
each from the port's step with f64 activations (the scans inside run in
f32).  ``tests/test_torch_ssm_train.py`` holds the two frameworks'
gradients against each other in f32 and only their losses in bf16,
because in bf16 both are mostly rounding on these random models.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/bf16_grad_check.py
"""
from __future__ import annotations

import types

import numpy as np
import jax
import jax.numpy as jnp
import torch

from repro.configs import get_arch as j_get_arch
from repro.kernels.rwkv6_scan import ops as j_rops
from repro.kernels.rwkv6_scan.ref import rwkv6_ref as j_rwkv6_ref
from repro.runtime import train as j_train
from repro_torch.configs import get_arch
from repro_torch.models import bridge, lm
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import train


def worst(got, want, n=3):
    return sorted((float(np.linalg.norm(np.float64(a) - np.float64(b)) /
                         np.linalg.norm(np.float64(b)))
                   for a, b in zip(got, want)), reverse=True)[:n]


def high_precision(params, tokens, cfg):
    """The port's step with every bf16 cast of the model made to f64."""
    proxy = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch)
                                     if not k.startswith("__")})
    proxy.bfloat16 = torch.float64
    saved = lm.torch, train.torch
    lm.torch = train.torch = proxy
    try:
        return train.value_and_grad(params, {"tokens": tokens}, cfg,
                                    train.TrainHyper(), None, 0)
    finally:
        lm.torch, train.torch = saved


def main() -> None:
    j_rops.rwkv6 = lambda r, k, v, w, u, s0=None, chunk=64, impl="jnp": \
        j_rwkv6_ref(r, k, v, w, u, s0)
    for arch in ("rwkv6-1.6b-smoke", "zamba2-7b-smoke"):
        cj, ct = j_get_arch(arch), get_arch(arch)
        state = jax.jit(j_train.make_state, static_argnums=0)(
            cj, jax.random.PRNGKey(0))
        tokens = np.random.default_rng(5).integers(
            1, cj.vocab, (2, 32)).astype(np.int32)
        (jl, _), jg = jax.jit(jax.value_and_grad(
            lambda p: j_train.loss_fn(p, {"tokens": jnp.asarray(tokens)},
                                      cj, j_train.TrainHyper(), None, 0),
            has_aux=True))(state["params"])
        params = bridge.from_jax(jax.tree.map(np.asarray, state["params"]),
                                 "cpu")
        tl, _, tg = train.value_and_grad(params, {"tokens": torch.from_numpy(
            tokens)}, ct, train.TrainHyper(), None, 0)
        hl, _, hg = high_precision(params, torch.from_numpy(tokens), ct)
        truth = [x.double().numpy() for x in tree_leaves(hg)]
        print(f"{arch}: loss port {float(tl):.7f}, reference {float(jl):.7f}"
              f", f64 {float(hl):.7f}; worst gradient leaves' rel L2 from "
              f"f64: port bf16 "
              f"{worst([x.numpy() for x in tree_leaves(tg)], truth)}, "
              f"reference bf16 "
              f"{worst([np.asarray(x) for x in jax.tree.leaves(jg)], truth)}",
              flush=True)


if __name__ == "__main__":
    main()
