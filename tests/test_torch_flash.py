"""The port's flash attention against the JAX package's.

The reference's Pallas flash kernel cannot serve as an oracle (it calls
``pl.load``, which jax 0.9 lacks, and asserts tile divisibility), so the
oracles are its ``attention_ref`` and ``chunked_attention`` and
``jax.grad`` of ``chunked_attention``.  On the CPU the dispatcher takes the
plain version (the port's ``chunked_attention``, differentiated by
autograd); it is held on f32 inputs within 1e-5 (forward) and 1e-4
(gradients) of the output's scale — sums in another order.  On the card
(``cuda`` marker, skipped without a GPU) the forward and backward kernels
are held against the materialised f32 oracle on the same inputs: within
1e-5 / 1e-4 of the scale for f32 inputs, and for bf16 inputs within 2e-2
of the scale (the output and the gradients are rounded to bf16 once, and
the probabilities where they meet V) — the plain version in bf16 is held
to the same bound beside it.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import attention as j_attn
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.flash_attention import MAX_HEAD_DIM
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import attention

# (B, Sq, Sk, H, KH, hd, causal, window, q_offset): causal self-attention
# with GQA, a sliding window, a ragged decode-like chunk (Sq != Sk, with
# q_offset), non-causal cross attention at zamba2's head size, and
# gemma3-1b's local attention (head dim 256, one KV head of 4, a window)
CASES = [(2, 37, 37, 4, 2, 64, True, None, 0),
         (1, 40, 40, 2, 2, 112, True, 8, 0),
         (2, 7, 12, 4, 4, 64, True, None, 5),
         (1, 9, 23, 2, 1, 112, False, None, 0),
         (1, 40, 40, 4, 1, 256, True, 8, 0)]
_IDS = ["causal-gqa", "window", "q_offset", "cross-hd112",
        "window-gqa-hd256"]

_j_chunked = jax.jit(j_attn.chunked_attention,
                     static_argnames=("causal", "window", "q_offset",
                                      "kv_chunk"))


def _inputs(rng, b, sq, sk, h, kh, hd):
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, sk, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, sk, kh, hd)).astype(np.float32)
    return q, k, v


def _heads_first(x, n_rep):
    """[B,S,KH,hd] numpy -> [B,KH*n_rep,S,hd] (the refs' layout)."""
    return np.repeat(x, n_rep, axis=2).transpose(0, 2, 1, 3)


def _close(got, ref, tol):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_plain_forward_matches_reference(rng, case):
    b, sq, sk, h, kh, hd, causal, window, q_offset = case
    q, k, v = _inputs(rng, b, sq, sk, h, kh, hd)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    ref = np.asarray(_j_chunked(*map(jnp.asarray, (q, k, v)), kv_chunk=16,
                                **mask))
    j_mat = np.asarray(j_attention_ref(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        *(jnp.asarray(_heads_first(x, h // kh)) for x in (k, v)),
        **mask)).transpose(0, 2, 1, 3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fops.flash_attention(tq, tk, tv, **mask)
    _close(got.numpy(), ref, 1e-5)
    _close(got.numpy(), j_mat, 1e-5)
    chunked = attention.chunked_attention(tq, tk, tv, kv_chunk=16, **mask)
    _close(chunked.numpy(), ref, 1e-5)
    mat = attention_ref(tq.transpose(1, 2),
                        *(torch.from_numpy(_heads_first(x, h // kh))
                          for x in (k, v)), **mask)
    _close(mat.transpose(1, 2).numpy(), j_mat, 1e-5)


@pytest.mark.parametrize("case", CASES, ids=_IDS)
def test_plain_backward_matches_jax_grad(rng, case):
    b, sq, sk, h, kh, hd, causal, window, q_offset = case
    q, k, v = _inputs(rng, b, sq, sk, h, kh, hd)
    g = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    mask = dict(causal=causal, window=window, q_offset=q_offset)

    def j_loss(q, k, v):
        return jnp.sum(j_attn.chunked_attention(q, k, v, **mask) * g)

    ref = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fops.flash_attention(*ts, **mask)
    (out * torch.from_numpy(g)).sum().backward()
    for t, r in zip(ts, ref):
        _close(t.grad.numpy(), np.asarray(r), 1e-4)


def test_bf16_plain_forward_matches_reference(rng):
    """bf16 inputs: the port keeps the P·V product in f32, as the
    reference's compiled scan does, so the two agree to a bf16 ulp of each
    value plus one of the output's scale (XLA's exp is an approximation,
    so the chunks' rescaling factors differ in the last f32 bits)."""
    q, k, v = _inputs(rng, 2, 33, 33, 4, 2, 64)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(_j_chunked(jq, jk, jv, kv_chunk=16).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = fops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -8 * float(np.abs(ref).max()))


def test_bf16_plain_backward_matches_jax_grad_with_a_shared_key_component(
        rng):
    """bf16 queries, keys and values that share a common component, as a
    model's do (gemma3-1b's one KV head): the port's plain backward, whose
    rounded P takes P's gradient through a plain cast as the reference's
    does, against ``jax.grad`` of the reference's bf16 chunked attention.
    The reference rounds its cotangents to bf16 where the port keeps them
    in f32 (each is about 1e-2 and 5e-3 from the f64 gradients), so the
    bound is 2e-2 relative L2 per gradient."""
    s, h, hd, window = 256, 4, 64, 32
    common = 2.0 * rng.standard_normal(hd)
    q, k, v = ((rng.standard_normal((1, s, n, hd)) + common)
               .astype(np.float32) for n in (h, 1, 1))
    do = rng.standard_normal((1, s, h, hd)).astype(np.float32)
    j_do = jnp.asarray(do).astype(jnp.bfloat16)

    def j_grads(q, k, v):
        _, vjp = jax.vjp(lambda *x: j_attn.chunked_attention(
            *x, window=window), q, k, v)
        return vjp(j_do)

    ref = jax.jit(j_grads)(*(jnp.asarray(x).astype(jnp.bfloat16)
                             for x in (q, k, v)))
    ts = [torch.from_numpy(x).bfloat16().requires_grad_(True)
          for x in (q, k, v)]
    got = torch.autograd.grad(fops.flash_attention(*ts, window=window), ts,
                              torch.from_numpy(do).bfloat16())
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        r = np.asarray(r.astype(jnp.float32), dtype=np.float64)
        err = np.linalg.norm(a.double().numpy() - r) / np.linalg.norm(r)
        assert err < 2e-2, (name, err)


def test_plain_version_counts_no_launches(rng):
    q, k, v = map(torch.from_numpy, _inputs(rng, 1, 8, 8, 2, 2, 16))
    reset_launches()
    fops.flash_attention(q, k, v)
    assert LAUNCHES["flash_fwd"] == LAUNCHES["flash_bwd"] == 0


def test_cuda_impl_refuses_cpu_tensors(rng):
    q, k, v = map(torch.from_numpy, _inputs(rng, 1, 8, 8, 2, 2, 16))
    with pytest.raises(ValueError):
        fops.flash_attention(q, k, v, impl="cuda")


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# lengths on and off the kernels' 64-row tiles (1, 63, 65, 1000), the four
# head dims of the bf16 kernels (64, 112, 128 and 256, and 136 padded up to
# 256), windows, a one-row decode-like chunk at a q_offset, and cross
# attention; at hd 256, gemma3-1b's local attention (window 1024 over 1100
# rows, one KV head of 4), a ragged length and a decode row
GPU_CASES = [(2, 200, 200, 4, 4, 64, True, None, 0),
             (1, 1000, 1000, 2, 2, 112, True, None, 0),
             (2, 130, 130, 2, 1, 128, True, 48, 0),
             (1, 70, 150, 2, 2, 64, True, None, 80),
             (1, 65, 129, 3, 3, 112, False, None, 0),
             (1, 1, 65, 2, 2, 64, False, None, 0),
             (1, 63, 63, 2, 2, 128, True, None, 0),
             (2, 65, 65, 4, 2, 112, True, None, 0),
             (2, 1, 300, 2, 2, 112, True, None, 299),
             (1, 1000, 1000, 2, 1, 64, True, 100, 0),
             (1, 63, 1000, 2, 2, 128, False, None, 0),
             (1, 1100, 1100, 4, 1, 256, True, 1024, 0),
             (2, 130, 130, 4, 1, 256, True, None, 0),
             (2, 1, 300, 4, 4, 256, True, None, 299),
             (1, 65, 65, 2, 2, 136, True, None, 0)]
_GPU_IDS = ["causal", "ragged-1000-hd112", "window-gqa-hd128", "q_offset",
            "cross", "len1-cross", "len63-hd128", "len65-gqa-hd112",
            "decode-row-q_offset", "window-1000-gqa", "cross-63x1000-hd128",
            "window-1024-gqa-hd256", "ragged-130-gqa-hd256",
            "decode-row-q_offset-hd256", "len65-hd136"]


def _oracle(q, k, v, g, mask):
    """f32 forward and gradients of the materialised reference."""
    ts = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    n_rep = q.shape[2] // k.shape[2]
    out = attention_ref(ts[0].transpose(1, 2),
                        *(attention.repeat_kv(x, n_rep).transpose(1, 2)
                          for x in ts[1:]), **mask).transpose(1, 2)
    (out * g.float()).sum().backward()
    return out.detach(), [x.grad for x in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GPU_CASES, ids=_GPU_IDS)
def test_cuda_flash_matches_oracle(cuda, rng, dtype, case):
    b, sq, sk, h, kh, hd, causal, window, q_offset = case
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _inputs(rng, b, sq, sk, h, kh, hd))
    g = torch.from_numpy(rng.standard_normal((b, sq, h, hd))
                         .astype(np.float32)).to(cuda, dtype)
    if hd > MAX_HEAD_DIM[dtype]:
        # the f32 kernels stop at hd 128: the wrapper raises, launches
        # nothing and takes no plain version in their place
        reset_launches()
        with pytest.raises(ValueError, match="hd <= 128"):
            fops.flash_attention(q, k, v, impl="cuda", **mask)
        assert LAUNCHES["flash_fwd"] == 0
        return
    ref, ref_grads = _oracle(q, k, v, g, mask)
    tol = (1e-5, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    for impl in ("cuda", "torch"):
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        reset_launches()
        out = fops.flash_attention(*ts, impl=impl, **mask)
        (out.float() * g.float()).sum().backward()
        torch.cuda.synchronize()
        want = (1, 1) if impl == "cuda" else (0, 0)
        assert (LAUNCHES["flash_fwd"], LAUNCHES["flash_bwd"]) == want
        assert out.dtype == dtype
        err = (out.float() - ref).abs().max().item()
        assert err <= tol[0] * ref.abs().max().item(), (impl, err)
        for t, r in zip(ts, ref_grads):
            assert t.grad.dtype == dtype
            err = (t.grad.float() - r).abs().max().item()
            assert err <= tol[1] * r.abs().max().item(), (impl, err)


@pytest.mark.cuda
def test_cuda_flash_backward_is_deterministic(cuda, rng):
    """dK/dV and dQ each have one writer, so two runs give the same bits."""
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _inputs(rng, 2, 300, 300, 4, 4, 64))
    g = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)
                         ).to(cuda, torch.bfloat16)
    runs = []
    for _ in range(2):
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fops.flash_attention(*ts).backward(g)
        runs.append([t.grad for t in ts])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [12, 100])
def test_cuda_bf16_refuses_head_dims_off_8(cuda, rng, hd):
    """The tensor-core kernels copy 16-byte chunks of a row: the bf16 route
    raises for hd % 8 != 0 and never falls back."""
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _inputs(rng, 1, 16, 16, 2, 2, hd))
    reset_launches()
    with pytest.raises(ValueError, match="hd % 8"):
        fops.flash_attention(q, k, v)
    assert LAUNCHES["flash_fwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 264),
                                      (torch.float32, 136)])
def test_cuda_refuses_head_dims_past_each_route(cuda, rng, dtype, hd):
    """bf16 runs up to hd 256 and f32 up to 128: past them the wrapper
    raises before any launch and never falls back."""
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _inputs(rng, 1, 16, 16, 2, 2, hd))
    reset_launches()
    with pytest.raises(ValueError, match=f"hd <= {MAX_HEAD_DIM[dtype]}"):
        fops.flash_attention(q, k, v)
    assert LAUNCHES["flash_fwd"] == 0
