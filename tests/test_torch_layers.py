"""The port's layers, attention, parameter declarations and bridge against
the JAX package, on the same numpy inputs.

Tolerances: f32 math within 1e-5; bf16 outputs within one bf16 ulp of the
output scale (2**-7 relative), since the two frameworks round bf16 at
different points.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.models import attention, bridge, layers, lm
from repro_torch.models.params import ParamDef

BF16_RTOL = 2.0 ** -7


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") and \
        not isinstance(x, torch.Tensor) else x.float().numpy()


def _bf16_pair(a):
    """The same bf16 values on both sides."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, bridge.from_jax(np.asarray(j))


def test_rms_norm_bf16(rng):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    jx, tx = _bf16_pair(x)
    ref = j_layers.rms_norm(jx, jnp.asarray(g), 1e-6)
    got = layers.rms_norm(tx, torch.tensor(g), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(ref), rtol=BF16_RTOL, atol=1e-6)


def test_rms_norm_f32(rng):
    x = rng.standard_normal((4, 32)).astype(np.float32)
    g = rng.standard_normal(32).astype(np.float32)
    ref = j_layers.rms_norm(jnp.asarray(x), jnp.asarray(g))
    got = layers.rms_norm(torch.tensor(x), torch.tensor(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(rng, theta):
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 6))
    ref = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_swiglu(rng):
    x = rng.standard_normal((3, 16)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.2
          for s in ((16, 32), (16, 32), (32, 16))]
    ref = j_layers.swiglu(jnp.asarray(x), *map(jnp.asarray, ws))
    got = layers.swiglu(torch.tensor(x), *map(torch.tensor, ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_repeat_kv(rng):
    k = rng.standard_normal((2, 3, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        attention.repeat_kv(torch.tensor(k), 3).numpy(),
        np.asarray(j_attn.repeat_kv(jnp.asarray(k), 3)))


@pytest.mark.parametrize("kv_chunk", [4, 1024])
def test_chunked_attention(rng, kv_chunk):
    q, k, v = (rng.standard_normal((2, 11, 4, 8)).astype(np.float32)
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]                 # GQA: 2 kv heads
    ref = j_attn.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                   kv_chunk=kv_chunk)
    got = attention.chunked_attention(*map(torch.tensor, (q, k, v)),
                                      kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_decode_attention_per_row_positions(rng):
    """Each row attends to its own prefix ``idx <= pos[b]``; each row
    against the reference's scalar-position call."""
    b, smax, h, kh, hd = 3, 10, 4, 2, 8
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, smax, kh, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.array([0, 4, 9])
    jq, tq = _bf16_pair(q)
    jk, tk = _bf16_pair(kc)
    jv, tv = _bf16_pair(vc)
    got = attention.decode_attention(tq, tk, tv, torch.tensor(pos))
    for r in range(b):
        ref = j_attn.decode_attention(jq[r:r + 1], jk[r:r + 1], jv[r:r + 1],
                                      int(pos[r]))
        np.testing.assert_allclose(_np(got[r:r + 1]), _np(ref),
                                   rtol=BF16_RTOL, atol=1e-2)


def test_decode_attention_fp8_cache_dequantizes(rng):
    q = torch.tensor(rng.standard_normal((1, 1, 2, 8)), dtype=torch.bfloat16)
    kc = torch.tensor(rng.standard_normal((1, 4, 2, 8)),
                      dtype=torch.float8_e4m3fn)
    out = attention.decode_attention(q, kc, kc, torch.tensor([3]))
    ref = attention.decode_attention(q, kc.to(torch.bfloat16),
                                     kc.to(torch.bfloat16),
                                     torch.tensor([3]))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("arch", ["paper-moe-100m", "olmoe-1b-7b"])
def test_model_defs_match_reference_tree(arch):
    """Same nested keys and shapes as the JAX declaration (the bridge's
    contract), at full width; nothing is allocated."""
    ref = j_lm.model_defs(j_get_arch(arch))
    got = lm.model_defs(get_arch(arch))

    def shapes(tree, leaf):
        if isinstance(tree, dict):
            return {k: shapes(v, leaf) for k, v in tree.items()}
        return tuple(tree.shape) if leaf(tree) else tree

    is_def = lambda d: hasattr(d, "shape") and hasattr(d, "init")  # noqa
    assert shapes(got, lambda d: isinstance(d, ParamDef)) == \
        shapes(ref, is_def)


def test_bridge_keeps_keys_dtypes_and_layer_dims():
    cfg = j_get_arch("paper-moe-100m-smoke")
    params = jax.jit(j_lm.init, static_argnums=0)(cfg,
                                                  jax.random.PRNGKey(0))
    params["moe"]["ln1"] = params["moe"]["ln1"].astype(jnp.bfloat16)
    t = bridge.from_jax(jax.tree.map(np.asarray, params))
    assert t["moe"]["w_gate"].shape == params["moe"]["w_gate"].shape
    assert t["moe"]["w_gate"].shape[0] == cfg.num_layers
    assert t["moe"]["ln1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t["moe"]["ln1"].float().numpy(),
        np.asarray(params["moe"]["ln1"].astype(jnp.float32)))
    np.testing.assert_array_equal(t["embed"].numpy(),
                                  np.asarray(params["embed"]))


def test_torch_init_is_seeded_and_shaped():
    cfg = get_arch("paper-moe-100m-smoke")
    a = lm.init(cfg, torch.Generator().manual_seed(3))
    b = lm.init(cfg, torch.Generator().manual_seed(3))
    assert torch.equal(a["moe"]["router"], b["moe"]["router"])
    assert torch.all(a["moe"]["ln1"] == 1)
    assert a["embed"].std().item() == pytest.approx(0.02, rel=0.1)
