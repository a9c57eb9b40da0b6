"""The port's speculative decode arms against the JAX package and against
the port's own plain decode.

* The n-gram hash and window push are the reference's own closures
  (captured from ``repro.engine.serve.build_slot_tick``), compared with the
  port's ``ng_hash`` / ``ng_push`` on 1000 seeded contexts, exactly.
* Under a forced ``spec:ngram`` arm, the reference engine (its own weights)
  and the port's engine (the same weights through ``bridge.from_jax``)
  serve the same greedy requests: tokens, the n-gram tables ``ng`` and
  windows ``ctx``, and the speculative counters equal exactly.  bf16
  rounding can resolve a near-tie differently in the two frameworks (see
  tests/test_torch_serve.py), so the inputs are fixed ones, independent of
  PYTEST_SEED, on which both decode alike — prompts that repeat a 3-token
  motif, so the tables have something to propose.
* Inside the port, greedy output under a forced ``spec:ngram`` arm, and a
  forced ``spec:draft`` arm with the truncated self-draft and with the
  target as its own draft, equals ``generate_static`` token for token for
  the MoE family, the recurrent ones (their rows must freeze at a
  rejected step) and ``gemma3-1b`` (a rejected step writes no row of its
  rolling ``local`` rings; its self-draft is one ``local`` block); the
  target as its own draft accepts every proposal.
* On the card (``cuda`` marker), the graphed speculative tick gives the
  eager tick's tokens, counts, positions and pool state bit for bit.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.engine import serve as j_serve
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.engine import ServeEngine
from repro_torch.engine.serve import SlotPool, SlotTick, ng_hash, ng_push
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.models import bridge, lm
from repro_torch.runtime.serve import BatchedServer, serving_params

ARCH = "paper-moe-100m-smoke"
ARCHS = [ARCH, "rwkv6-1.6b-smoke", "zamba2-7b-smoke", "gemma3-1b-smoke"]
MAX_LEN = 48


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke-size torch ops run fastest on one thread, and the suite's
    parallel workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, j=False):
    """The smoke config with both fused MoE flags on and a 1-block
    self-draft (the smoke models have 2 layers)."""
    c = (j_get_arch if j else get_arch)(arch)
    c = dataclasses.replace(c, serve=dataclasses.replace(c.serve,
                                                         draft_layers=1))
    if c.moe is not None:
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, fused_gating=True, fused_dispatch=True))
    return c


def force_arm(eng, arm):
    """Pin every decode tick to ``arm`` (bypassing the engine's cost
    decision, as tests/test_serve_differential.py does)."""
    orig = eng.engine.choose_serve_tick

    def forced(*a, **k):
        mode = orig(*a, **k)
        return arm if mode.startswith(("decode", "spec")) \
            and k.get("spec_len", 0) > 1 else mode

    eng.engine.choose_serve_tick = forced


def _ref_hash_push(cfg_j):
    """The reference tick's own n-gram hash and push closures: a proposer
    registered for one build hands them out."""
    got = {}

    class Capture(j_serve.Proposer):
        name = "capture"

        @staticmethod
        def build(cfg, draft_cfg, ng_hash, push):
            got["hash"], got["push"] = ng_hash, push
            return lambda *a: None

    j_serve.PROPOSERS["capture"] = Capture
    try:
        j_serve.build_slot_tick.__wrapped__(cfg_j, 2, None, "capture")
    finally:
        del j_serve.PROPOSERS["capture"]
    return got["hash"], got["push"]


@pytest.mark.parametrize("n_ctx,table", [(2, 512), (1, 64), (4, 1024)])
def test_ngram_hash_and_push_match_reference(n_ctx, table):
    cfg_j = j_get_arch(ARCH)
    cfg_j = dataclasses.replace(cfg_j, serve=dataclasses.replace(
        cfg_j.serve, spec_ctx=n_ctx, spec_table=table))
    j_hash, j_push = _ref_hash_push(cfg_j)
    rng = np.random.default_rng(123)
    ctx = rng.integers(0, 2 ** 31 - 1, (1000, n_ctx)).astype(np.int32)
    ctx[:500] %= 65536                  # token ids of real vocabularies
    tok = rng.integers(0, 2 ** 31 - 1, (1000,)).astype(np.int32)
    want = np.asarray(jax.jit(jax.vmap(j_hash))(jnp.asarray(ctx)))
    got = ng_hash(torch.from_numpy(ctx), table).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax.jit(jax.vmap(j_push))(jnp.asarray(ctx),
                                                jnp.asarray(tok)))
    got = ng_push(torch.from_numpy(ctx), torch.from_numpy(tok)).numpy()
    np.testing.assert_array_equal(got, want)


@lru_cache(maxsize=None)
def _weights():
    cfg_j = _cfg(ARCH, j=True)
    params = jax.jit(j_lm.init, static_argnums=0)(cfg_j,
                                                  jax.random.PRNGKey(0))
    return params, bridge.from_jax(jax.tree.map(np.asarray, params),
                                   device="cpu")


def _motif_prompts(seed):
    motif = np.random.default_rng(seed).integers(1, 512, 3)
    return [np.tile(np.roll(motif, i), 4)[:10].astype(np.int32)
            for i in range(3)]


def _serve(eng, prompts):
    force_arm(eng, "spec:ngram")
    reqs = [eng.submit(p, 16) for p in prompts]
    eng.run_until_done()
    return np.stack([r.output() for r in reqs])


@lru_cache(maxsize=None)
def _ref_run(seed):
    """The reference engine's forced-ngram serve: tokens, tables, counters.
    Three slots, equal prompt lengths: every tick's composition and length
    follow from the tokens alone."""
    eng = j_serve.ServeEngine(_cfg(ARCH, j=True), _weights()[0],
                              max_len=MAX_LEN, slots=3, prefill_chunk=4,
                              decode_chunk=2, spec_decode=True)
    out = _serve(eng, _motif_prompts(seed))
    pool = eng.pools[0].pool
    return out, np.asarray(pool["ng"]), np.asarray(pool["ctx"]), \
        (eng.spec_ticks, eng.spec_proposed, eng.spec_accepted,
         {a: dict(c) for a, c in eng.spec_arms.items()})


@pytest.mark.parametrize("seed", [9, 14])
def test_ngram_tables_and_counters_match_reference(seed):
    ref_out, ref_ng, ref_ctx, ref_counts = _ref_run(seed)
    eng = ServeEngine(_cfg(ARCH), _weights()[1], max_len=MAX_LEN, slots=3,
                      prefill_chunk=4, decode_chunk=2, spec_decode=True,
                      device="cpu")
    out = _serve(eng, _motif_prompts(seed))
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(eng.pool.ng.numpy(), ref_ng)
    np.testing.assert_array_equal(eng.pool.ctx.numpy(), ref_ctx)
    assert (eng.spec_ticks, eng.spec_proposed, eng.spec_accepted,
            eng.spec_arms) == ref_counts
    assert ref_counts[2] > 0            # the tables proposed accepted tokens


@lru_cache(maxsize=None)
def _own(arch):
    """A family's port weights (the port's own init) and static oracle."""
    cfg = _cfg(arch)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, BatchedServer(cfg, params, max_len=MAX_LEN,
                                      device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("arm", ["ngram", "self", "target"])
def test_forced_spec_arm_equals_static(rng, arch, arm):
    """More requests than slots, mixed lengths, a motif so the n-gram arm
    accepts some: every output equals a one-row static run."""
    cfg, params, srv = _own(arch)
    kw = {"ngram": {}, "self": {"draft": "self"},
          "target": {"draft_cfg": cfg, "draft_params": params}}[arm]
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=2,
                      prefill_chunk=4, decode_chunk=2, spec_decode=True,
                      device="cpu", **kw)
    force_arm(eng, "spec:ngram" if arm == "ngram" else "spec:draft")
    motif = rng.integers(1, cfg.vocab, 4)
    prompts = [np.tile(motif, 4)[:n].astype(np.int32) for n in (5, 9, 13)]
    reqs = [eng.submit(p, 12) for p in prompts]
    eng.run_until_done()
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(
            r.output(), srv.generate_static(p[None], 12)[0],
            err_msg=f"plen={len(p)}")
    st = eng.spec_arms["ngram" if arm == "ngram" else "draft"]
    assert st["ticks"] > 0 and st["proposed"] > 0
    assert (eng.spec_ticks, eng.spec_proposed, eng.spec_accepted) == \
        (st["ticks"], st["proposed"], st["accepted"])
    if arm == "target":
        assert st["accepted"] == st["proposed"]


def test_spec_len_update_and_sampled_rows_run_plain():
    """A hot spec_len change takes effect at the next tick; a sampled
    decode participant keeps the arms off (greedy verify would change its
    distribution)."""
    cfg, params, _ = _own(ARCH)
    eng = ServeEngine(cfg, params, max_len=MAX_LEN, slots=2,
                      prefill_chunk=4, decode_chunk=2, spec_decode=True,
                      device="cpu")
    force_arm(eng, "spec:ngram")
    eng.update(spec_len=2)
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new=8, temperature=0.9)
    eng.run_until_done()
    assert eng.spec_len == 2 and eng.spec_ticks == 0
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new=8)
    eng.run_until_done()
    assert eng.spec_ticks > 0
    assert eng.spec_proposed == eng.spec_ticks      # one draft a tick at 2
    assert eng._inspect("spec")["knobs"]["spec_len"] == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("arm", ["ngram", "draft"])
def test_cuda_graphed_spec_tick_equals_eager_tick(cuda, rng, arch, arm):
    """A prefill tick and two speculative ticks (the target as its own
    draft for the draft arm) through the graphed and the eager tick, on two
    pools in the same state: every step's logits, the tokens, the counts,
    the positions and every pool leaf equal bit for bit; each replay of
    either graph credits its captured launches."""
    cfg, params, _ = _own(arch)
    params = serving_params(params, cuda)
    dcfg, dparams = (cfg, params) if arm == "draft" else (None, None)
    pools = [SlotPool(cfg, 4, 32, cuda, dcfg) for _ in range(2)]
    ticks = [SlotTick(cfg, cuda, graph=g, draft_cfg=dcfg)
             for g in (True, False)]
    for t in ticks:
        t.record = []
    temps, gens = np.zeros(4, np.float32), [None] * 4
    active = np.array([1, 1, 1, 0], bool)
    motif = rng.integers(1, cfg.vocab, 3)
    toks = np.tile(motif, 3)[None, :8].repeat(4, 0)
    outs = [t(p, params, dparams, toks, np.array([8, 8, 8, 1]), active,
              np.ones(4, bool), temps, gens) for t, p in zip(ticks, pools)]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    reset_launches()
    for _ in range(2):
        dec = np.zeros((4, 4), np.int64)
        dec[:, 0] = outs[0][1][np.arange(4), np.maximum(outs[0][2] - 1, 0)]
        outs = [t(p, params, dparams, dec, np.ones(4, np.int64), active,
                  np.zeros(4, bool), temps, gens, arm=arm)
                for t, p in zip(ticks, pools)]
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
        np.testing.assert_array_equal(outs[0][2], outs[1][2])
    assert torch.equal(pools[0].pos, pools[1].pos)
    for j, (a, b) in enumerate(zip(*(t.record for t in ticks))):
        assert torch.equal(a, b), f"step {j}"
    for (path, a, _), (_, b, _) in zip(pools[0].row_leaves(),
                                       pools[1].row_leaves()):
        assert torch.equal(a, b), path
    if arm == "draft":
        assert outs[0][2][:3].tolist() == [4, 4, 4]     # all accepted
    # 8 verify steps replayed and 8 run eagerly (on the card the eager
    # tick launches the kernels too); for the draft arm 6 propose steps
    # replayed, 6 eager, and the propose graph's capture in this window
    # ran one eager warm-up step
    g = ticks[0].graphs
    want = {k: 16 * g["step"].per_replay[k] for k in LAUNCHES}
    if arm == "draft":
        for k in LAUNCHES:
            want[k] += 13 * g["propose"].per_replay[k]
    assert LAUNCHES == want
    reset_launches()
