"""Async snapshot-then-persist checkpointing in the port, against the JAX
package's (tests/test_async_checkpoint.py).

Checkpointer: each case runs the same operations on the port's and the
reference's ``Checkpointer`` and holds the outcomes equal (the steps
listed, acknowledged and restored), and a directory the reference wrote
restores in the port: the file names, the pickled host-numpy payloads and
the ack manifest (the durable-log barrier) are one format.

Loop: with ``ckpt_async`` the next training step (the port's step updates
the state in place) runs while the persist worker writes; the blocking
baseline's payload carries what the reference's carries; a crash between
step 4's publish and its ack recovers at step 2 and replays the logged
update, giving the uninterrupted run's parameters bit for bit.

Publish: ``TrainLoop(publish_to=ServeEngine)`` with a checkpoint on the
same step reuses the snapshot's host copy; the served tokens equal the
static loop on the trained weights.  The mid-stream publish itself is held
in tests/test_torch_publish.py and the placed pools' re-commit in
tests/test_torch_pool_placement.py.
"""
import json
import os
import pickle
import threading
import time

import numpy as np
import jax
import pytest
import torch

import repro.checkpoint.checkpointer as j_ckpt
import repro.configs as j_configs
import repro.data.synthetic as j_data
import repro.runtime.loop as j_loop
import repro.runtime.train as j_train
from repro_torch.checkpoint import checkpointer as t_ckpt
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_arch
from repro_torch.core import messages as M
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine.serve import ServeEngine
from repro_torch.models import bridge, lm
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.loop import LoopConfig, TrainLoop
from repro_torch.runtime.serve import BatchedServer
from repro_torch.runtime.train import TrainHyper

ARCH = "gemma3-1b-smoke"
CFG = get_arch(ARCH)
MAX_LEN = 64
WAIT = 60
BOTH = (t_ckpt.Checkpointer, j_ckpt.Checkpointer)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk_loop(tmp, ckpt_every=0, ckpt_async=True, publish_every=0,
            publish_to=None):
    stream = TokenStream(vocab=CFG.vocab, seq_len=16, global_batch=4, seed=3)
    return TrainLoop(CFG, stream, TrainHyper(),
                     LoopConfig(microbatches=2, ckpt_every=ckpt_every,
                                ckpt_dir=tmp, ckpt_async=ckpt_async,
                                publish_every=publish_every, device="cpu"),
                     publish_to=publish_to)


def _both(tmp_path, case):
    """``case(Checkpointer, directory)`` for the port's class and the
    reference's, each in its own directory; the two outcomes."""
    return [case(cls, str(tmp_path / name))
            for cls, name in zip(BOTH, ("port", "ref"))]


# --------------------------------------------------------- checkpointer unit

def test_list_steps_full_stem_parse(tmp_path):
    """Steps >= 10**8 give 9-digit file names; the step is parsed from the
    whole stem, so latest-step selection and retention see them."""
    def case(cls, d):
        ck = cls(d, keep=3)
        big = 10 ** 8
        for s in (7, big):
            ck.save(s, {"w": np.arange(3)})
        return (ck.list_steps(), ck.latest_step(), ck.restore()["step"],
                ck.restore(step=7)["step"], sorted(os.listdir(d)))

    got, ref = _both(tmp_path, case)
    assert got == ref
    assert got[:4] == ([7, 10 ** 8], 10 ** 8, 10 ** 8, 7)


def test_snapshot_decouples_from_live_state(tmp_path):
    """The snapshot's payload is a host copy: changing the live state
    afterwards (the port's next step changes it in place, a tensor here)
    does not leak into what persists."""
    state = {"w": torch.arange(4.0), "n": np.arange(4.0)}
    ck = Checkpointer(str(tmp_path))
    payload = ck.snapshot(3, state)
    state["w"] += 100.0
    state["n"] += 100.0
    seen = []
    ck.persist_async(payload, on_done=seen.append)
    ck.wait()
    back = ck.restore()["state"]
    np.testing.assert_array_equal(back["w"], np.arange(4.0))
    np.testing.assert_array_equal(back["n"], np.arange(4.0))
    assert len(seen) == 1 and seen[0] > 0.0   # measured persist wall time


def test_wait_reraises_worker_error(tmp_path):
    for cls in BOTH:
        d = tmp_path / cls.__module__
        ck = cls(str(d))
        payload = ck.snapshot(1, {"w": np.zeros(2)})
        ck.persist_async(payload)
        ck.wait()
        bad = dict(payload, step=2)
        ck.dir = str(d / "gone")            # worker-side failure
        ck.persist_async(bad)
        with pytest.raises(OSError):
            ck.wait()


def test_torn_tmp_write_is_invisible(tmp_path):
    """Crash mid-write: a partial ``.tmp`` file was never renamed, so
    restore never considers it and returns the previous step."""
    def case(cls, d):
        ck = cls(d)
        ck.save(1, {"w": np.ones(2)})
        with open(ck._path(2) + ".tmp", "wb") as f:
            f.write(pickle.dumps({"step": 2})[:7])
        return ck.list_steps(), ck.restore()["step"]

    got, ref = _both(tmp_path, case)
    assert got == ref == ([1], 1)


def test_published_but_unacked_is_not_restorable(tmp_path):
    """Crash between the atomic rename and the manifest ack: the file is
    published but never acknowledged, so recovery falls back to the
    previous acknowledged step."""
    def case(cls, d):
        ck = cls(d)
        ck.save(2, {"w": np.ones(2) * 2})
        ck.save(4, {"w": np.ones(2) * 4})
        lines = open(ck._manifest()).read().splitlines()
        acked = [json.loads(ln)["step"] for ln in lines]
        with open(ck._manifest(), "w") as f:
            f.write(lines[0] + "\n")
        return (acked, ck.list_steps(), ck.restorable_steps(),
                ck.restore()["step"])

    got, ref = _both(tmp_path, case)
    assert got == ref == ([2, 4], [2, 4], [2], 2)


def test_acked_but_corrupt_falls_back(tmp_path):
    """An acknowledged file corrupted on disk falls back to the next older
    readable checkpoint instead of raising."""
    def case(cls, d):
        ck = cls(d)
        ck.save(1, {"w": np.ones(2)})
        ck.save(2, {"w": np.ones(2) * 2})
        with open(ck._path(2), "wb") as f:
            f.write(b"\x80\x04corrupt")
        return ck.restore()["step"]

    assert _both(tmp_path, case) == [1, 1]


def test_torn_manifest_line_skipped(tmp_path):
    """A torn trailing ack line (crash mid-ack) is not an ack."""
    def case(cls, d):
        ck = cls(d)
        ck.save(1, {"w": np.zeros(1)})
        ck.save(2, {"w": np.zeros(1)})
        with open(ck._manifest(), "a") as f:
            f.write('{"step": ')
        return ck.restorable_steps(), ck.restore()["step"]

    assert _both(tmp_path, case) == [([1, 2], 2)] * 2


def test_legacy_dir_without_manifest(tmp_path):
    """A directory without MANIFEST.log (written before the ack barrier)
    keeps restoring: every published file is trusted.  A directory the
    reference wrote restores in the port, and the other way round."""
    def case(cls, d):
        ck = cls(d)
        ck.save(5, {"w": np.ones(3)})
        os.remove(ck._manifest())
        ck2 = cls(d)
        return ck2.acked_steps(), ck2.restore()["step"]

    assert _both(tmp_path, case) == [(None, 5)] * 2
    for writer, reader in (BOTH, BOTH[::-1]):
        d = str(tmp_path / f"x{writer.__module__}")
        writer(d).save(3, {"w": np.arange(5, dtype=np.float32)},
                       [], {"lr_scale": 0.5})
        back = reader(d).restore()
        assert back["step"] == 3 and back["extra"] == {"lr_scale": 0.5}
        np.testing.assert_array_equal(back["state"]["w"],
                                      np.arange(5, dtype=np.float32))


# ----------------------------------------------------- persist/step overlap

def test_persist_overlaps_next_step(tmp_path, monkeypatch):
    """With ckpt_async the next training step runs while the persist worker
    is still writing: the persist of the step-2 checkpoint is held on an
    event, and the loop still completes steps 3 and 4 before it is
    released."""
    loop = mk_loop(str(tmp_path), ckpt_every=2)
    started, release = threading.Event(), threading.Event()
    orig = Checkpointer.persist

    def gated_persist(self, payload):
        started.set()
        assert release.wait(WAIT), "the test never released the persist"
        return orig(self, payload)

    monkeypatch.setattr(Checkpointer, "persist", gated_persist)
    th = threading.Thread(target=lambda: loop.run(4))
    th.start()
    try:
        assert started.wait(WAIT), "persist never started"
        deadline = time.perf_counter() + WAIT
        while len(loop.history) < 4:          # steps 3, 4 run DURING persist
            assert time.perf_counter() < deadline, \
                "the next steps did not overlap the in-flight persist"
            time.sleep(0.01)
    finally:
        release.set()
        th.join(WAIT)
    assert not th.is_alive()
    # both checkpoints landed durably by the time run() returned (wait())
    assert loop.ckpt.restorable_steps() == [2, 4]
    assert loop.engine.jobs_run["ckpt_snapshot"] == 2
    assert loop.engine.jobs_run["ckpt_persist"] == 2


def test_blocking_baseline_matches_reference(tmp_path):
    """ckpt_async=False persists inline: restorable at once, and its
    payload carries what the reference's carries (step, stream position,
    lr scale, no plan for a dense model, the control log), from the same
    initial state."""
    cfg_j = j_configs.get_arch(ARCH)
    jl = j_loop.TrainLoop(
        cfg_j, j_data.TokenStream(vocab=cfg_j.vocab, seq_len=16,
                                  global_batch=4, seed=3),
        j_train.TrainHyper(),
        j_loop.LoopConfig(microbatches=2, ckpt_every=2,
                          ckpt_dir=str(tmp_path / "ref"), ckpt_async=False))
    loop = mk_loop(str(tmp_path / "port"), ckpt_every=2, ckpt_async=False)
    loop.state = bridge.state_from_jax(jax.tree.map(np.asarray, jl.state),
                                       device="cpu")
    for lp in (jl, loop):
        lp.run(1)
        lp.controller.send(M.update(lr_scale=0.5))
        lp.run(1)
    ref = jl.ckpt.restore()
    payload = loop.ckpt.restore()
    assert payload["step"] == ref["step"] == 2
    assert payload["extra"] == ref["extra"]
    assert payload["extra"]["lr_scale"] == 0.5
    assert [(r.kind, r.payload, r.step, r.microbatch)
            for r in payload["control_log"]] == \
        [(r.kind, r.payload, r.step, r.microbatch)
         for r in ref["control_log"]]
    assert set(payload["state"]) == set(ref["state"]) == \
        {"params", "opt", "step"}
    assert loop.ckpt.restorable_steps() == jl.ckpt.restorable_steps() == [2]


def test_crash_mid_persist_recovers_previous_with_replay(tmp_path):
    """Checkpoints at steps 2 and 4 with an lr update logged at step 2; the
    crash lands between step 4's publish and its ack.  Recovery comes up
    at step 2, never the unacknowledged step 4, and replays the logged
    update at its point: the uninterrupted run's parameters bit for bit."""
    ref = mk_loop(str(tmp_path / "a"), ckpt_every=2)
    ref.run(2)
    ref.controller.send(M.update(lr_scale=0.25))
    ref.run(2)

    db = str(tmp_path / "b")
    loop = mk_loop(db, ckpt_every=2)
    loop.run(2)
    loop.controller.send(M.update(lr_scale=0.25))
    loop.run(2)
    del loop
    man = os.path.join(db, Checkpointer.MANIFEST)
    lines = open(man).read().splitlines()
    with open(man, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n")

    rec = TrainLoop.recover(
        CFG, TokenStream(vocab=CFG.vocab, seq_len=16, global_batch=4,
                         seed=3), TrainHyper(),
        LoopConfig(microbatches=2, ckpt_every=2, ckpt_dir=db, device="cpu"))
    assert int(rec.state["step"]) == 2
    rec.run(2)
    assert rec.lc.lr_scale == 0.25
    for a, b in zip(tree_leaves(ref.state["params"]),
                    tree_leaves(rec.state["params"])):
        assert torch.equal(a, b)


# ------------------------------------------------------ live weight publish

def test_trainloop_publish_hook_end_to_end(tmp_path):
    """TrainLoop(publish_to=ServeEngine, publish_every=2) with a checkpoint
    every 2 steps: the publish reuses the step-2 snapshot's host copy (one
    device sync for both), the engine swaps at its next tick boundary, and
    its greedy output equals the static loop on the trained weights."""
    serve = ServeEngine(CFG, lm.init(CFG, torch.Generator().manual_seed(0),
                                     device="cpu"),
                        max_len=MAX_LEN, slots=2, prefill_chunk=4,
                        decode_chunk=2, device="cpu")
    loop = mk_loop(str(tmp_path), ckpt_every=2, publish_every=2,
                   publish_to=serve)
    loop.run(2)
    assert loop._last_snapshot is not None
    assert loop._last_snapshot["step"] == 2
    prompt = np.arange(3, 10, dtype=np.int32)
    req = serve.submit(prompt, max_new=5)
    while not req.done.is_set():
        assert serve.tick()
    assert serve.params_version == 2
    rec = [r for r in serve.engine.controller.log if r.kind == "update"]
    assert rec and rec[-1].payload["params"] is \
        loop._last_snapshot["state"]["params"]
    trained = loop.state["params"]
    want = BatchedServer(CFG, trained, max_len=MAX_LEN, device="cpu") \
        .generate_static(prompt[None], 5)[0]
    np.testing.assert_array_equal(req.output(), want)
