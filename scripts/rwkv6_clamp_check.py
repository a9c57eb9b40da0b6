"""How far the JAX package's chunked RWKV6 scan is from the exact
recurrence at model-range decays.

``rwkv6_chunked`` and ``rwkv6_pallas`` factor the decay as
exp(la_prev) * exp(min(-la, 30)), which is exact only while the cumulative
decay inside one chunk stays above e^-30.  This prints, against the
sequential ``rwkv6_ref``, the y and final-state errors of the chunked forms
on synthetic inputs (four rows: chunk 128 at decays near e^-1 and over the
model's whole range, the Pallas kernel in interpret mode, and chunk 16 near
e^-1), then the same for the scan inputs of layer 1 of
``rwkv6-1.6b-smoke`` with the reference's own weights (seed 0) at the
smoke config's chunk of 16.  The PyTorch port computes the exact
recurrence, and its tests use ``rwkv6_ref`` as the oracle.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/rwkv6_clamp_check.py
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from repro.configs import get_arch
from repro.kernels.rwkv6_scan import ops
from repro.kernels.rwkv6_scan.ref import rwkv6_ref
from repro.kernels.rwkv6_scan.rwkv6_scan import rwkv6_pallas
from repro.models import blocks, lm


def _row(name, t, chunk, y_ref, s_ref, y, s):
    print(f"{name:34s} T={t:4d} chunk={chunk:3d}  max|y| "
          f"{float(jnp.abs(y_ref).max()):8.4f}  max|y err| "
          f"{float(jnp.abs(y - y_ref).max()):.3g}  max|sT err| "
          f"{float(jnp.abs(s - s_ref).max()):.3g}")


def synthetic(rng):
    b, h, n = 1, 2, 64
    near = lambda s: np.exp(-1.0) * rng.uniform(0.99, 1.01, s)  # noqa: E731
    full = lambda s: rng.uniform(0.0113, 0.9997, s)             # noqa: E731
    for t, chunk, label, draw, fn in [
            (128, 128, "chunked, w ~ e^-1", near, ops.rwkv6_chunked),
            (256, 128, "chunked, w in [0.0113, 0.9997]", full,
             ops.rwkv6_chunked),
            (128, 128, "pallas, w in [0.0113, 0.9997]", full, rwkv6_pallas),
            (128, 16, "chunked, w ~ e^-1", near, ops.rwkv6_chunked)]:
        r, k, v = (0.5 * rng.standard_normal((b, h, t, n)) for _ in range(3))
        u = 0.1 * rng.standard_normal((h, n))
        args = [jnp.asarray(a, jnp.float32)
                for a in (r, k, v, draw((b, h, t, n)), u)]
        y0, s0 = rwkv6_ref(*args)
        y1, s1 = fn(*args, chunk=chunk)
        _row(label, t, chunk, y0, s0, y1, s1)


def smoke_layer1():
    """The scan inputs of layer 1 of the smoke model, captured through the
    reference's own forward, and its chunked form at the config's chunk."""
    cfg = get_arch("rwkv6-1.6b-smoke")
    params = lm.init(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 32))
    x = params["embed"][jnp.asarray(toks)].astype(jnp.bfloat16)
    ctx = {"cfg": cfg, "impl": "jnp"}
    layer = lambda i: jax.tree.map(lambda a: a[i], params["rwkv"])  # noqa
    x = blocks.rwkv_apply(layer(0), x, ctx)
    seen = {}
    chunked = ops.rwkv6

    def spy(r, k, v, w, u, s0=None, chunk=64, impl="jnp"):
        seen["args"] = (r, k, v, w, u)
        return chunked(r, k, v, w, u, s0, chunk, impl)

    ops.rwkv6 = spy
    try:
        blocks.rwkv_apply(layer(1), x, ctx)
    finally:
        ops.rwkv6 = chunked
    r, k, v, w, u = seen["args"]
    wf = np.asarray(w.astype(jnp.float32))
    b, h, t, n = wf.shape
    q = cfg.ssm.chunk
    la = np.cumsum(np.log(wf.reshape(b, h, t // q, q, n)), axis=3)
    print(f"rwkv6-1.6b-smoke layer 1: w in [{wf.min():.4f}, {wf.max():.4f}]"
          f", least cumulative log decay in a {q}-token chunk {la.min():.2f}"
          f" (the clamp is at -30)")
    y0, s0 = rwkv6_ref(r, k, v, w, u)
    y1, s1 = ops.rwkv6_chunked(r, k, v, w, u, chunk=q)
    _row("chunked, smoke layer 1", t, q, y0, s0, y1, s1)


if __name__ == "__main__":
    synthetic(np.random.default_rng(0))
    smoke_layer1()
