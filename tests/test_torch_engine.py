"""The port's engine layer against the JAX package's (tests/test_engine.py):
Maestro decisions over measured job costs, the continuous-batching
ServeEngine, and the TrainLoop as an engine client.

* The CostBook, the job workflows and every ``choose_*`` decision: each
  case feeds the same observations to the port's ``Engine`` and the
  reference's and holds the returned choices and the whole ``decisions``
  trail (kind, choice, why, scores, inputs) equal, with no tolerance (the
  engine is the reference's code, copied).
* The serve engine and the loop hold the reference's invariants inside the
  port: greedy engine output ≡ ``generate_static``, mixed-length requests
  joining and leaving the pool, a hot chunk update that never strands a
  request, and one ``Engine`` shared by a ``TrainLoop`` and a
  ``ServeEngine``.

Held elsewhere, not repeated here: inspect and update between ticks
(tests/test_torch_serve.py::test_engine_inspect_and_update_between_ticks),
a breakpoint pausing the stream
(::test_engine_breakpoint_pauses_stream) and seeded sampling
(::test_engine_sampling_is_seeded).  The reference's two donation audits
(``test_granulated_apply_migrate_donate_state``,
``test_grad_step_default_donation_matches_backend``) check XLA buffer
donation, which torch does not have; the port's in-place step is held by
tests/test_torch_adamw.py.
"""
import types

import numpy as np
import pytest
import torch

import repro.core.estimator as j_est
import repro.core.messages as JM
import repro.core.scheduler as j_sched
import repro.engine as j_engine
from repro_torch.configs import get_arch
from repro_torch.core import estimator as t_est
from repro_torch.core import messages as M
from repro_torch.core import scheduler as t_sched
from repro_torch import engine as t_engine
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine import Engine, ServeEngine
from repro_torch.models import lm
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from repro_torch.runtime.serve import BatchedServer
from repro_torch.runtime.train import TrainHyper

PORT = types.SimpleNamespace(E=t_engine, M=M, est=t_est, sched=t_sched)
REF = types.SimpleNamespace(E=j_engine, M=JM, est=j_est, sched=j_sched)
ARCH = "gemma3-1b-smoke"


@pytest.fixture(autouse=True)
def _torch_settings():
    """One torch thread and the native GEMM (see tests/test_torch_compact.py:
    oneDNN's bf16 GEMM rounds rows by the batch height)."""
    n, mk = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mk


def _same(case):
    """``case(fw)`` on both packages; the port's outcome, after holding it
    equal to the reference's."""
    got, ref = case(PORT), case(REF)
    assert got == ref
    return got


def _trail(eng):
    return [dict(d) for d in eng.decisions]


# ------------------------------------------------------------ cost book

def test_costbook_warmup_skip_and_ema():
    def case(fw):
        eng = fw.E.Engine()
        eng.observe(fw.E.Job("k", tokens=10), 99.0)   # warm-up discarded
        out = [eng.costs.estimate("k")]
        eng.observe(fw.E.Job("k", tokens=10), 1.0)
        return out + [eng.costs.estimate("k"), eng.costs.estimate("k_per_tok"),
                      dict(eng.jobs_run), eng.costs.snapshot()]
    got = _same(case)
    assert got[0] is None and abs(got[1] - 1.0) < 1e-9
    assert abs(got[2] - 0.1) < 1e-9 and got[3]["k"] == 2 and "k" in got[4]


def test_costbook_default_until_measured():
    def case(fw):
        cb = fw.est.CostBook()
        out = [cb.estimate("missing"), cb.estimate("missing", 0.5)]
        cb.observe("missing", 2.0)
        return out + [cb.estimate("missing", 0.5)]
    assert _same(case) == [None, 0.5, 2.0]


def test_costbook_observe_rate_clamps_to_unit_interval():
    def case(fw):
        cb = fw.est.CostBook()
        cb.observe_rate("acc", 1.7)
        out = [cb.estimate("acc")]
        for _ in range(30):
            cb.observe_rate("acc", -3.0)
        return out + [cb.estimate("acc")]
    got = _same(case)
    assert got[0] == 1.0 and got[1] >= 0.0


# ----------------------------------------------------- job/region workflows

def test_train_step_workflow_frt_vs_completion():
    """Granulated: first response after one microbatch but a longer drain;
    fused: one region, FRT equals completion — the step-path decision."""
    def case(fw):
        cm = fw.sched.CostModel()
        wf_g = fw.E.train_step_workflow("granulated", 4, 0.1, t_apply=0.02)
        wf_f = fw.E.train_step_workflow("fused", 4, 0.08, t_apply=0.02)
        return [fw.sched.first_response_time(wf_g, frozenset(), cm),
                fw.sched.first_response_time(wf_f, frozenset(), cm),
                fw.sched.completion_time(wf_g, cm),
                fw.sched.completion_time(wf_f, cm)]
    frt_g, frt_f, c_g, c_f = _same(case)
    assert abs(frt_g - 0.1) < 1e-9
    assert abs(frt_f - (4 * 0.08 + 0.02)) < 1e-9
    assert frt_g < frt_f and c_f < c_g


def test_serve_tick_workflow_decode_preempts_prefill():
    def case(fw):
        cm = fw.sched.CostModel()
        wf_d = fw.E.serve_tick_workflow(2, 4, 0, t_token=0.01)
        wf_p = fw.E.serve_tick_workflow(2, 16, 64, t_token=0.01)
        return [fw.sched.first_response_time(wf_d, frozenset(), cm),
                fw.sched.first_response_time(wf_p, frozenset(), cm),
                fw.sched.score_choices(wf_p, cm, objective="frt")[0][0]]
    frt_d, frt_p, score = _same(case)
    assert frt_d < frt_p and score == pytest.approx(frt_p)


def test_serve_decode_workflow_commit_cardinality_tracks_acceptance():
    """The spec arm's sink cardinality is the expected committed-token
    count; the verify region's time is paid either way."""
    def case(fw):
        cm = fw.sched.CostModel()
        wf_hi = fw.E.serve_decode_workflow("spec", 2, 4, 1e-4, accept=1.0)
        wf_lo = fw.E.serve_decode_workflow("spec", 2, 4, 1e-4, accept=0.0)
        return [fw.sched.cardinalities(wf_hi)["stream_out"],
                fw.sched.cardinalities(wf_lo)["stream_out"],
                fw.sched.completion_time(wf_hi, cm),
                fw.sched.completion_time(wf_lo, cm)]
    hi, lo, c_hi, c_lo = _same(case)
    assert hi == pytest.approx(8) and lo == pytest.approx(2)
    assert c_hi == pytest.approx(c_lo)


# ------------------------------------------------------------ engine choices

def test_choose_step_path_interactive_forces_granulated():
    def case(fw):
        eng = fw.E.Engine()
        out = [eng.choose_step_path("auto", 2)]
        eng.controller.mailbox.put(fw.M.inspect())
        out.append(eng.choose_step_path("auto", 2))
        eng.controller.mailbox.get_nowait()
        eng.controller.paused = True
        out.append(eng.choose_step_path("auto", 2))
        eng.controller.paused = False
        out += [eng.choose_step_path("fused", 2),
                eng.choose_step_path("granulated", 2)]
        return out, _trail(eng)
    got, _ = _same(case)
    assert got == ["fused", "granulated", "granulated", "fused",
                   "granulated"]


def test_choose_step_path_follows_measured_costs():
    def case(fw):
        eng = fw.E.Engine()
        for t in (0.2, 0.2):                  # first observation: warm-up
            eng.observe(fw.E.Job("train_step_fused"), t)
            eng.observe(fw.E.Job("train_step_fused"), t)
        for t in (0.05, 0.05):
            eng.observe(fw.E.Job("train_step_granulated"), t)
            eng.observe(fw.E.Job("train_step_granulated"), t)
        return eng.choose_step_path("auto", 2), _trail(eng)
    choice, trail = _same(case)
    assert choice == "granulated"
    assert trail[-1]["scores"]["granulated"] < trail[-1]["scores"]["fused"]


def test_choose_serve_tick_spec_arm_switches_on_measured_acceptance():
    """With measured runtimes fixed, the pool's acceptance EMA high vs low
    flips the decode arm."""
    def case(fw):
        eng = fw.E.Engine()
        out = [eng.choose_serve_tick(2, 0, 0, 4, 16, spec_len=4)]
        for _ in range(3):
            eng.observe(fw.E.Job("serve_decode", tokens=100), 1.0e-2)
            eng.observe(fw.E.Job(fw.E.spec_kind("ngram"), tokens=100),
                        0.8e-2)
        for _ in range(4):
            eng.observe_accept(0, 0.9)
        out.append(eng.choose_serve_tick(2, 0, 0, 4, 16, spec_len=4))
        for _ in range(12):
            eng.observe_accept(0, 0.0)
        out.append(eng.choose_serve_tick(2, 0, 0, 4, 16, spec_len=4))
        out.append(eng.choose_serve_tick(2, 0, 0, 4, 16, spec_len=0))
        return out, _trail(eng)
    picks, trail = _same(case)
    assert picks == ["spec:ngram", "spec:ngram", "decode", "decode"]
    scored = [d for d in trail if "scores" in d and "spec:ngram" in
              d["scores"]]
    assert scored[0]["scores"]["spec:ngram"] < scored[0]["scores"]["decode"]
    assert scored[-1]["scores"]["decode"] < scored[-1]["scores"]["spec:ngram"]


def test_choose_serve_tick_spec_arm_reexplores_loser():
    def case(fw):
        eng = fw.E.Engine()
        for _ in range(3):
            eng.observe(fw.E.Job("serve_decode", tokens=100), 1.0e-2)
            eng.observe(fw.E.Job(fw.E.spec_kind("ngram"), tokens=100),
                        1.0e-2)
        for _ in range(8):
            eng.observe_accept(0, 0.0)        # spec is the losing arm
        return [eng.choose_serve_tick(2, 0, 0, 4, 16, spec_len=4)
                for _ in range(16)], _trail(eng)
    picks, trail = _same(case)
    assert picks[:15] == ["decode"] * 15 and picks[15] == "spec:ngram"
    assert trail[-1]["why"] == "re-explore"


def test_choose_decode_arm_family_prices_each_proposer():
    """{plain, spec:ngram, spec:draft}: each spec arm bootstraps on its own,
    then is priced from its own acceptance and runtime EMAs."""
    arms = ("ngram", "draft")

    def case(fw):
        eng = fw.E.Engine()
        out = [eng.choose_serve_tick(2, 0, 0, 4, 16, spec_len=4, arms=arms)]
        for _ in range(3):
            eng.observe(fw.E.Job("serve_decode", tokens=100), 1.0e-2)
            eng.observe(fw.E.Job(fw.E.spec_kind("ngram"), tokens=100),
                        0.8e-2)
            eng.observe(fw.E.Job(fw.E.spec_kind("draft"), tokens=100),
                        0.9e-2)
        for _ in range(8):
            eng.observe_accept(0, 0.05, arm="ngram")
            eng.observe_accept(0, 0.9, arm="draft")
        out.append(eng.choose_serve_tick(2, 0, 0, 4, 16, spec_len=4,
                                         arms=arms))
        eng2 = fw.E.Engine()
        for _ in range(3):
            eng2.observe(fw.E.Job("serve_decode", tokens=100), 1.0e-2)
            eng2.observe(fw.E.Job(fw.E.spec_kind("ngram"), tokens=100),
                         0.8e-2)
        for _ in range(4):
            eng2.observe_accept(0, 0.5, arm="ngram")
        out.append(eng2.choose_serve_tick(2, 0, 0, 4, 16, spec_len=4,
                                          arms=arms))
        return out, _trail(eng), _trail(eng2)
    picks, trail, trail2 = _same(case)
    assert picks[0].startswith("spec:") and trail[0]["why"] == "bootstrap"
    assert picks[1] == "spec:draft"
    s = trail[-1]["scores"]
    assert set(s) == {"decode", "spec:ngram", "spec:draft"}
    assert s["spec:draft"] < s["decode"] < s["spec:ngram"]
    assert trail[-1]["inputs"]["accept:draft"] > \
        trail[-1]["inputs"]["accept:ngram"]
    assert picks[2] == "spec:draft" and trail2[-1]["why"] == "bootstrap"


def test_choose_compact_is_a_measured_layout_arm():
    def case(fw):
        eng = fw.E.Engine()
        out = [eng.choose_compact(0)]
        for _ in range(3):
            eng.observe(fw.E.Job(fw.E.layout_kind(True, 0), tokens=100),
                        1.0e-2)
        out.append(eng.choose_compact(0))
        for _ in range(3):
            eng.observe(fw.E.Job(fw.E.layout_kind(False, 0), tokens=100),
                        2.0e-2)
        out.append(eng.choose_compact(0))
        eng2 = fw.E.Engine()
        for _ in range(3):
            eng2.observe(fw.E.Job(fw.E.layout_kind(True, 0), tokens=100),
                         3.0e-2)
            eng2.observe(fw.E.Job(fw.E.layout_kind(False, 0), tokens=100),
                         1.0e-2)
        out.append(eng2.choose_compact(0))
        out.append([eng2.choose_compact(0) for _ in range(16)])
        return out, _trail(eng), _trail(eng2)
    out, trail, trail2 = _same(case)
    assert out[:4] == [True, False, True, False]
    assert [d["why"] for d in trail[:2]] == ["bootstrap", "explore"]
    assert trail[2]["scores"]["compact"] < trail[2]["scores"]["full"]
    assert out[4][:14] == [False] * 14 and out[4][14] is True
    assert any(d.get("why") == "re-explore" for d in trail2[-16:])


def test_choose_serve_tick_aging_bounds_prefill_starvation():
    def case(fw):
        eng = fw.E.Engine(max_prefill_defer=3)
        picks = [eng.choose_serve_tick(decode_slots=2, prefill_slots=1,
                                       prefill_tokens=64, decode_chunk=4,
                                       prefill_chunk=16) for _ in range(8)]
        picks += [eng.choose_serve_tick(0, 1, 64, 4, 16),
                  eng.choose_serve_tick(2, 0, 0, 4, 16)]
        return picks, _trail(eng)
    picks, _ = _same(case)
    assert picks[:3] == ["decode"] * 3 and picks[3] == "prefill"
    assert picks[8:] == ["prefill", "decode"]


# ------------------------------------------------------------- serve engine

def _params():
    cfg = get_arch(ARCH)
    return cfg, lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_serve_engine_matches_static_batched_server():
    """Chunked batched prefill and the slot tick reproduce the static
    one-token-a-step loop exactly (greedy)."""
    cfg, params = _params()
    srv = BatchedServer(cfg, params, max_len=64, device="cpu")
    prompts = np.random.default_rng(3).integers(
        1, cfg.vocab, (4, 11)).astype(np.int32)
    ref = srv.generate_static(prompts, max_new=10)
    np.testing.assert_array_equal(srv.generate(prompts, max_new=10), ref)


def test_serve_engine_continuous_join_evict_mixed_lengths():
    """More requests than slots, mixed prompt lengths: every request
    finishes with max_new tokens, each equal to a fresh static run."""
    cfg, params = _params()
    eng = ServeEngine(cfg, params, max_len=64, slots=2, prefill_chunk=8,
                      decode_chunk=4, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, (n,)).astype(np.int32)
               for n in (3, 9, 14, 6, 9)]
    reqs = [eng.submit(p, max_new=6) for p in prompts]
    eng.run_until_done()
    assert all(r.done.is_set() for r in reqs)
    assert eng.engine.jobs_run.get("serve_prefill", 0) >= 1
    srv = BatchedServer(cfg, params, max_len=64, device="cpu")
    for p, r in zip(prompts, reqs):
        np.testing.assert_array_equal(
            r.output(), srv.generate_static(p[None, :], max_new=6)[0],
            err_msg=f"plen={len(p)}")


def test_serve_engine_chunk_hot_update_never_strands_requests():
    """Raising the chunk sizes mid-stream past the headroom reserved at
    submit shrinks the tick instead of stranding near-full slots."""
    cfg, params = _params()
    eng = ServeEngine(cfg, params, max_len=32, slots=2, prefill_chunk=8,
                      decode_chunk=4, device="cpu")
    reqs = [eng.submit(np.arange(1, 9, dtype=np.int32), max_new=12)
            for _ in range(2)]
    eng.tick()
    eng.engine.controller.send(M.update(decode_chunk=64, prefill_chunk=64))
    eng.run_until_done()
    assert eng.decode_chunk == 64
    for r in reqs:
        assert r.done.is_set() and len(r.output()) == 12


# ------------------------------------------------- loop as an engine client

def _stream(cfg):
    return TokenStream(vocab=cfg.vocab, seq_len=8, global_batch=2)


def test_trainloop_is_engine_client():
    cfg = get_arch(ARCH)
    loop = TrainLoop(cfg, _stream(cfg), TrainHyper(),
                     LoopConfig(microbatches=2, device="cpu"))
    assert loop.controller is loop.engine.controller
    loop.run(3)
    assert loop.engine.jobs_run.get("train_step_fused", 0) >= 1
    # warm-up skipped, later steps measured
    assert "train_step_fused" in loop.engine.costs.snapshot()
    info = loop._inspect("engine")
    assert info["engine"]["jobs_run"]["train_step_fused"] >= 1


def test_trainloop_shared_engine_across_train_and_serve():
    """One engine owns the control plane of both workload kinds."""
    cfg = get_arch(ARCH)
    shared = Engine()
    loop = TrainLoop(cfg, _stream(cfg), TrainHyper(),
                     LoopConfig(microbatches=1, device="cpu"), engine=shared)
    loop.run(2)
    serve = ServeEngine(cfg, loop.state["params"], max_len=48, slots=2,
                        prefill_chunk=4, decode_chunk=2, engine=shared,
                        device="cpu")
    serve.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
    serve.run_until_done()
    assert {"train_step_fused", "serve_prefill"} <= set(shared.jobs_run)
    assert serve.engine.controller is loop.controller
