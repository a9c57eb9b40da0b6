"""The MoE layer at its published routing widths, and the dense configs,
against the JAX package.

``reduced()`` cuts every MoE smoke config to 8 experts top-2, so no other
test sees top-8.  Here ``olmoe-1b-7b-smoke`` and
``qwen3-moe-235b-a22b-smoke`` get their published ``MoECfg`` back (64 and
128 experts, top-8, 16 spare slots; a narrow expert d_ff of 32), one MoE
layer, the fused gating and dispatch flags on, and for qwen3 a head dim
of twice ``d_model / n_heads`` (a q dim of 128 against a d_model of 64,
as the full model's 8192 against 4096).  The reference runs its gating,
dispatch and combine through its Pallas kernels in interpret mode.

Tolerances, with their reasons:

* Integer outputs (expert ids, phi, ranks, keep masks, routed, kept and
  drop counts): equal.
* Gating weights: 1e-5 (tests/test_torch_kernels.py); the MoE layer on f32
  activations 1e-5 (tests/test_torch_moe.py), on bf16 2e-2.
* Whole-model logits against the reference: atol 0.25, rtol 0.1,
  tests/test_torch_ssm.py's ``REF_ATOL``, except at a token the MoE routes
  elsewhere at a router near-tie of at most 4 bf16 ulps (the training
  check's bound in chip_smoke.py); forward against step-by-step
  decode inside the port: atol 0.08, rtol 0.1 (the reference's default in
  tests/test_serve_consistency.py).
* Serving: greedy ``ServeEngine`` output equals ``generate_static``.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.kernels.moe_dispatch.ops as j_dops
from repro.configs import get_arch as j_get_arch
from repro.kernels.moe_dispatch.moe_dispatch import dispatch_pallas
from repro.kernels.moe_gating.moe_gating import gating_pallas
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro_torch.configs import get_arch
from repro_torch.engine import ServeEngine
from repro_torch.kernels.moe_dispatch import ops as dops
from repro_torch.kernels.moe_gating import ops as gops
from repro_torch.models import bridge, lm, moe
from repro_torch.runtime.serve import BatchedServer

MOE_ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")
DENSE_ARCHS = ("starcoder2-7b", "yi-34b", "command-r-plus-104b")
REF_ATOL = 0.25
DECODE_ATOL = 0.08
FLIP_MARGIN_ULPS = 4
_j_route = jax.jit(j_moe.route, static_argnums=(4,))
_j_moe_ffn = jax.jit(j_moe.moe_ffn, static_argnums=(4,))


@pytest.fixture(autouse=True)
def _torch_setup():
    """One torch thread (the suite's parallel workers would otherwise
    oversubscribe the cores), and the native GEMM: oneDNN's bf16 GEMM
    rounds some rows by the product's height, which the engine's batch and
    the static loop's single row do not share."""
    n, dnn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = dnn


@pytest.fixture
def pallas_dispatch(monkeypatch):
    """The reference's fused dispatch/combine through its Pallas kernels
    (interpret mode); compiled functions traced under it are dropped
    afterwards, so no other test sees them."""
    monkeypatch.setattr(j_dops, "_resolve", lambda impl: "interpret")
    yield
    jax.clear_caches()


def _wide(cfg, full):
    """The smoke config ``cfg`` with ``full``'s published routing, one MoE
    layer, fused gating and dispatch; for a published head dim wider than
    d_model / n_heads (qwen3), twice the smoke's."""
    hd = cfg.hd * 2 if full.hd * full.n_heads != full.d_model else cfg.hd
    return dataclasses.replace(
        cfg, num_layers=1, layer_pattern=("moe",), head_dim=hd,
        moe=dataclasses.replace(full.moe, expert_d_ff=32, fused_gating=True,
                                fused_dispatch=True))


@lru_cache(maxsize=None)
def _setup(arch):
    """Both configs, the reference's weights, the port's copy of them."""
    cfg_j = _wide(j_get_arch(arch + "-smoke"), j_get_arch(arch))
    cfg = _wide(get_arch(arch + "-smoke"), get_arch(arch))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_j)
    params = jax.jit(j_lm.init, static_argnums=0)(cfg_j,
                                                  jax.random.PRNGKey(0))
    return cfg_j, cfg, params, bridge.from_jax(
        jax.tree.map(np.asarray, params), device="cpu")


def _plans(cfg_j, hot):
    """Identity plans, or (hot) expert 0 split over the first two spare
    slots with fractions (0.4, 0.7, 1.0)."""
    jplan = j_moe.identity_plan(cfg_j, 1)
    slots, cum = np.asarray(jplan.slots[0]).copy(), \
        np.asarray(jplan.cum[0]).copy()
    if hot:
        e = cfg_j.moe.num_experts
        slots[0, :3] = [0, e, e + 1]
        cum[0, :3] = [0.4, 0.7, 1.0]
    return (jnp.asarray(slots), jnp.asarray(cum)), \
        (torch.from_numpy(slots).long(), torch.from_numpy(cum))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_published_widths(arch):
    cfg_j, cfg, _, tp = _setup(arch)
    m = cfg.moe
    assert (m.top_k, m.spare_slots) == (8, 16)
    assert m.num_experts == {"olmoe-1b-7b": 64,
                             "qwen3-moe-235b-a22b": 128}[arch]
    assert tp["moe"]["w_gate"].shape[1] == m.num_experts + 16
    assert tp["moe"]["wq"].shape[-1] == cfg.n_heads * cfg.hd
    if arch.startswith("qwen3"):
        assert cfg.n_heads * cfg.hd == 2 * cfg.d_model
        assert tp["moe"]["wo"].shape[1:] == (2 * cfg.d_model, cfg.d_model)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_gating_matches_pallas(rng, arch):
    """Router logits at k 8 over 64 and 128 experts, one row with every
    expert tied: ids and phi equal, weights within 1e-5."""
    _, cfg, _, _ = _setup(arch)
    e, k, t = cfg.moe.num_experts, cfg.moe.top_k, 24
    logits = rng.standard_normal((t, e)).astype(np.float32)
    logits[0] = 0.5
    pw, pe, pc = gating_pallas(jnp.asarray(logits), k, bt=t, interpret=True)
    w, ids, counts = gops.gating(torch.from_numpy(logits)[None], k)
    np.testing.assert_array_equal(ids[0].numpy(), np.asarray(pe))
    np.testing.assert_array_equal(counts[0].numpy(), np.asarray(pc))
    np.testing.assert_allclose(w[0].numpy(), np.asarray(pw), atol=1e-5)
    np.testing.assert_array_equal(ids[0, 0].numpy(), np.arange(k))


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_and_dispatch_match_pallas(rng, arch, hot):
    """The router's slots and expert ids, then the dispatch's ranks, keep
    masks and routed and kept counts over every slot (spare ones included),
    at a capacity that drops assignments."""
    cfg_j, cfg, params, tp = _setup(arch)
    jp = jax.tree.map(lambda a: a[0], params["moe"])
    pp = {k: v[0] for k, v in tp["moe"].items()}
    t = 40
    x = rng.standard_normal((t, cfg.d_model)).astype(np.float32)
    (js, jc), (ts, tc) = _plans(cfg_j, hot)
    ref = _j_route(jp["router"], jnp.asarray(x), js, jc, cfg_j, 3)
    got = moe.route(pp["router"], torch.from_numpy(x)[None], ts, tc, cfg,
                    torch.tensor([3]))
    for i, name in ((0, "slot"), (3, "expert"), (4, "phi")):
        np.testing.assert_array_equal(got[i][0].numpy(), np.asarray(ref[i]),
                                      err_msg=name)
    slot = got[0][0].numpy()
    if hot:
        assert (slot >= cfg.moe.num_experts).any()         # replicas used
    n_slots, cap = moe.num_slots(cfg), 4
    valid = np.ones_like(slot)
    w = got[1][0].numpy()
    pb = dispatch_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(slot),
                         jnp.asarray(valid), n_slots, cap, bt=t,
                         interpret=True)
    out = dops.dispatch(torch.from_numpy(x)[None], torch.from_numpy(w)[None],
                        torch.from_numpy(slot)[None],
                        torch.from_numpy(valid)[None], n_slots, cap)
    for name, a, b in zip(("rank", "keep", "routed", "kept"), out[1:],
                          pb[1:]):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_allclose(out[0][0].numpy(), np.asarray(pb[0]),
                               atol=1e-5)
    assert int(out[4].sum()) < t * cfg.moe.top_k           # drops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(rng, pallas_dispatch, arch, dtype):
    cfg_j, cfg, params, tp = _setup(arch)
    jp = jax.tree.map(lambda a: a[0], params["moe"])
    pp = {k: v[0] for k, v in tp["moe"].items()}
    x = jnp.asarray(rng.standard_normal((32, cfg.d_model)), dtype)
    (js, jc), (ts, tc) = _plans(cfg_j, False)
    y, met = _j_moe_ffn(jp, x, js, jc, cfg_j)
    yt, mt = moe.moe_ffn(pp, bridge.from_jax(np.asarray(x), device="cpu")
                         [None], ts, tc, cfg, torch.tensor([0]))
    for k in ("slot_counts", "kept_counts", "dropped", "expert_counts"):
        np.testing.assert_array_equal(mt[k][0].numpy(), np.asarray(met[k]),
                                      err_msg=k)
    assert int(mt["dropped"][0]) > 0
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(yt[0].float().numpy(),
                               np.asarray(y.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_one_layer_forward_matches_reference(pallas_dispatch, monkeypatch,
                                             arch):
    """The layer's integer metrics against the reference's MoE layer on
    the port's own input to it, and the logits against the reference's
    forward.  The attention before the MoE rounds bf16 at other points in
    the two frameworks, which can move a router near-tie and so send a
    token to another expert set: a token whose logits part from the
    reference's must be one whose router top-k margin in the port is at
    most FLIP_MARGIN_ULPS bf16 ulps of its largest router logit."""
    cfg_j, cfg, params, tp = _setup(arch)
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 16))
    jl, _ = jax.jit(lambda p, t: j_lm.forward(p, {"tokens": t}, cfg_j))(
        params, jnp.asarray(toks, jnp.int32))
    seen, ffn = [], moe.moe_ffn

    def recorder(p, x, *args, **kw):
        seen.append(x)
        return ffn(p, x, *args, **kw)

    monkeypatch.setattr(moe, "moe_ffn", recorder)
    tl, aux = lm.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    (x,) = seen
    k = cfg.moe.top_k
    router = x[0].float() @ tp["moe"]["router"][0].to(x.dtype).float()
    top = router.topk(k + 1, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(router.abs().amax(-1))) - 7)
    near = ((top[:, k - 1] - top[:, k]) / ulp <= FLIP_MARGIN_ULPS).numpy()
    ref = np.asarray(jl)
    off = (np.abs(tl.numpy() - ref) > REF_ATOL + 0.1 * np.abs(ref)) \
        .any(-1).reshape(-1)
    assert not (off & ~near).any(), np.flatnonzero(off & ~near)
    jx = jnp.asarray(x[0].view(torch.int16).numpy().view(jnp.bfloat16))
    (js, jc), _ = _plans(cfg_j, False)
    _, met = _j_moe_ffn(jax.tree.map(lambda a: a[0], params["moe"]), jx,
                        js, jc, cfg_j)
    for k in ("expert_counts", "slot_counts", "kept_counts", "dropped"):
        np.testing.assert_array_equal(aux["moe"][k][0].numpy(),
                                      np.asarray(met[k]), err_msg=k)


@lru_cache(maxsize=None)
def _dense(arch):
    cfg_j = j_get_arch(arch + "-smoke")
    params = jax.jit(j_lm.init, static_argnums=0)(cfg_j,
                                                  jax.random.PRNGKey(0))
    return cfg_j, get_arch(arch + "-smoke"), params, bridge.from_jax(
        jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_forward_and_decode(arch):
    """The forward against the reference's, and step-by-step decode
    against the port's forward."""
    cfg_j, cfg, params, tp = _dense(arch)
    b, s = 2, 12
    toks = np.random.default_rng(0).integers(1, cfg.vocab, (b, s))
    jl, _ = jax.jit(lambda p, t: j_lm.forward(p, {"tokens": t}, cfg_j))(
        params, jnp.asarray(toks, jnp.int32))
    t = torch.from_numpy(toks)
    ref, _ = lm.forward(tp, {"tokens": t}, cfg)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jl), atol=REF_ATOL,
                               rtol=0.1)
    state = lm.init_cache(cfg, b, s + 4, device="cpu")
    got = []
    for i in range(s):
        lg, state = lm.decode_step(tp, state, t[:, i:i + 1], cfg)
        got.append(lg)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), ref.numpy(),
                               atol=DECODE_ATOL, rtol=0.1)


@pytest.mark.parametrize("arch", MOE_ARCHS + DENSE_ARCHS)
def test_engine_equals_static(arch):
    """Greedy ``ServeEngine`` (2 slots, each its own MoE group) against the
    static loop on one row at a time."""
    if arch in MOE_ARCHS:
        cfg = _setup(arch)[1]
    else:
        cfg = get_arch(arch + "-smoke")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    srv = BatchedServer(cfg, params, max_len=40, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in (4, 11, 7)]
    eng = ServeEngine(cfg, params, max_len=40, slots=2, prefill_chunk=4,
                      decode_chunk=2, device="cpu")
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run_until_done()
    for i, (p, r) in enumerate(zip(prompts, reqs)):
        np.testing.assert_array_equal(
            r.output(), srv.generate_static(p[None], 6)[0],
            err_msg=f"req {i}")


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("g,t,e", [(8, 1, 64), (1, 4096, 64), (1, 4096, 80),
                                   (4, 1, 128), (1, 2048, 128)])
def test_cuda_gating_top8_matches_plain(cuda, rng, g, t, e):
    """``gating_kernel<32, 2>`` (E 33-64) and ``<32, 4>`` (E 65-128) at
    top-8, at olmoe-1b-7b's and qwen3-moe's serve and forward shapes:
    ids and phi equal the plain version's, weights within 1e-6."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    x = torch.from_numpy(rng.standard_normal((g, t, e)).astype(np.float32)
                         ).to(cuda)
    reset_launches()
    w, ids, cnt = gops.gating(x, 8, impl="cuda")
    torch.cuda.synchronize()
    assert LAUNCHES["moe_gating"] == 1
    rw, rids, rcnt = gops.gating(x, 8, impl="torch")
    assert torch.equal(ids, rids) and torch.equal(cnt, rcnt)
    assert (w - rw).abs().max().item() <= 1e-6
