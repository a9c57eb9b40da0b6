"""Durable logging of tensors in the port's control plane, against the JAX
package's.

The durable control-replay log (``Controller.attach_durable_log``) writes
every state-effecting message as a JSON line, and recovery replays it
(§2.6.2).  A hot ``update(params=...)`` or ``update(draft_params=...)``
carries weights: in the reference a ``jax.Array`` (bf16 through
``ml_dtypes``), in the port a ``torch.Tensor`` on the card, often bf16.
numpy refuses both a CUDA tensor and a bf16 one, so the port encodes a
tensor itself: a host copy of its values (bf16 and f16 through f32, which
holds them exactly), its torch dtype and its shape, restored as a CPU
tensor of the same dtype and bits.

* A bf16, f16, f32, int and bool tensor in an ``update`` payload is logged,
  read back with the same dtype, shape and bits, and its values equal what
  the reference's ``read_durable_log`` gives back for the same values
  logged as a ``jax`` array (exactly: no tolerance).
* A tensor whose values cannot be read (``meta``, which numpy refuses as it
  refuses a CUDA tensor) no longer raises out of ``Controller.poll``: the
  record is logged as a tagged repr with a warning, as the reference does
  with a payload it cannot encode, and the update still applies.
* A serving run that receives ``update(draft_params=...)`` with bf16
  tensors, durably logged, replays through a ``ReplayingController`` into
  a fresh ``ServeEngine``: the same tokens, and the replayed draft's
  tensors equal the logged ones bit for bit.
* A record in the ``__ndarray__`` form of earlier logs still restores.
* On the card (``cuda`` marker) the same with tensors on the card.
"""
import json
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import messages as JM
from repro.core.controller import Controller as JController
from repro_torch.configs import get_arch
from repro_torch.core import messages as M
from repro_torch.core.controller import Controller, ReplayingController
from repro_torch.engine import Engine, ServeEngine, small_draft_cfg
from repro_torch.models import lm

ARCH = "paper-moe-100m-smoke"
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16),
          "float32": (torch.float32, jnp.float32),
          "int32": (torch.int32, jnp.int32),
          "bool": (torch.bool, jnp.bool_)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(rng, name, shape=(3, 5)):
    """Random values of ``name`` with both signed zeros, and the largest
    finite value of f16 where the dtype is f16."""
    if name == "bool":
        return rng.random(shape) < 0.5
    if name == "int32":
        i = np.iinfo(np.int32)
        return rng.integers(i.min, i.max, shape, dtype=np.int32,
                            endpoint=True)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x.flat[:3] = (-0.0, 0.0, 65504.0 if name == "float16" else 3.0e38)
    return x


def _bits(t):
    """The tensor's bits as integers (so -0.0 and 0.0 differ)."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _log(ctl_cls, msgs, path, step=2, microbatch=1):
    ctl = ctl_cls()
    ctl.attach_durable_log(path)
    for m in msgs:
        ctl.send(m)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r = ctl.poll(step=step, microbatch=microbatch)
    return r["updates"], [str(x.message) for x in w]


@pytest.mark.parametrize("name", list(DTYPES))
def test_tensor_payload_round_trips_as_the_reference(rng, tmp_path, name):
    tdt, jdt = DTYPES[name]
    vals = _values(rng, name)
    t = torch.as_tensor(vals).to(tdt)
    path = str(tmp_path / "port.log")
    applied, warned = _log(Controller, [M.update(
        draft_params={"blk": {"w": t}}, params_version=3, tensor=t)], path)
    assert not warned
    assert applied["params_version"] == 3 and applied["tensor"] is t
    (rec,) = Controller.read_durable_log(path)
    assert (rec.kind, rec.step, rec.microbatch) == ("update", 2, 1)
    for got in (rec.payload["draft_params"]["blk"]["w"],
                rec.payload["tensor"]):
        assert got.dtype == tdt and got.shape == t.shape
        assert got.device.type == "cpu"
        assert torch.equal(_bits(got), _bits(t))

    # the reference, the same values logged as a jax array
    jpath = str(tmp_path / "ref.log")
    _log(JController, [JM.update(draft_params={"blk": {"w": jnp.asarray(
        vals).astype(jdt)}}, params_version=3)], jpath)
    (jrec,) = JController.read_durable_log(jpath)
    assert (jrec.kind, jrec.step, jrec.microbatch) == \
        (rec.kind, rec.step, rec.microbatch)
    jw = np.asarray(jrec.payload["draft_params"]["blk"]["w"])
    assert str(jw.dtype) == name
    np.testing.assert_array_equal(
        rec.payload["draft_params"]["blk"]["w"].float().numpy()
        if name in ("bfloat16", "float16") else
        rec.payload["draft_params"]["blk"]["w"].numpy(),
        jw.astype(np.float32) if name in ("bfloat16", "float16") else jw)


def test_zero_dim_and_empty_tensors_keep_their_shape(tmp_path):
    path = str(tmp_path / "c.log")
    _log(Controller, [M.update(s=torch.tensor(7, dtype=torch.int64),
                               e=torch.zeros((0, 3), dtype=torch.bfloat16),
                               n=torch.tensor([float("nan"), -float("inf")]))],
         path, 0, 0)
    (rec,) = Controller.read_durable_log(path)
    assert rec.payload["s"].shape == () and int(rec.payload["s"]) == 7
    assert rec.payload["e"].shape == (0, 3)
    assert rec.payload["e"].dtype == torch.bfloat16
    n = rec.payload["n"]
    assert torch.isnan(n[0]) and n[1] == -float("inf")


def test_unreadable_tensor_keeps_poll_alive(tmp_path):
    """A ``meta`` tensor (numpy refuses it as it refuses a CUDA tensor, and
    its values cannot be copied out): ``poll`` does not raise, the record
    is logged as a tagged repr with a warning, and the update applies.
    The reference treats a payload it cannot encode the same way."""
    path = str(tmp_path / "c.log")
    meta = torch.zeros((4, 4), dtype=torch.bfloat16, device="meta")
    applied, warned = _log(Controller, [
        M.update(draft_params={"blk": {"w": meta}}),
        M.update(lr_scale=0.5)], path)
    assert any("durable log" in w and "meta" in w for w in warned)
    assert applied["lr_scale"] == 0.5
    assert applied["draft_params"]["blk"]["w"] is meta
    recs = Controller.read_durable_log(path)
    assert [r.kind for r in recs] == ["update", "update"]
    assert "__unserializable__" in recs[0].payload
    assert recs[1].payload == {"lr_scale": 0.5}

    jpath = str(tmp_path / "ref.log")
    _, jwarned = _log(JController, [JM.update(draft_params={"tags": {1}}),
                                    JM.update(lr_scale=0.5)], jpath)
    jrecs = JController.read_durable_log(jpath)
    assert [r.kind for r in jrecs] == [r.kind for r in recs]
    assert "__unserializable__" in jrecs[0].payload and jwarned
    assert jrecs[1].payload == recs[1].payload


def test_ndarray_record_of_earlier_logs_restores(tmp_path):
    """The ``__ndarray__`` encoding of numpy payloads is unchanged, so a log
    written before tensors had their own encoding (or by the reference)
    still reads, with numpy's dtype."""
    path = tmp_path / "old.log"
    slots = np.arange(8, dtype=np.int32).reshape(1, 2, 4)
    path.write_text(json.dumps({
        "kind": "plan", "payload": {
            "slots": {"__ndarray__": slots.tolist(), "dtype": "int32"},
            "cum": {"__ndarray__": [[0.25, 1.0]], "dtype": "float32"},
            "migrations": []},
        "seq": 4, "step": 3, "microbatch": 0}) + "\n")
    (rec,) = Controller.read_durable_log(str(path))
    assert isinstance(rec.payload["slots"], np.ndarray)
    np.testing.assert_array_equal(rec.payload["slots"], slots)
    assert rec.payload["slots"].dtype == np.int32
    assert rec.payload["cum"].dtype == np.float32

    jpath = str(tmp_path / "ref.log")
    _log(JController, [JM.set_plan(slots, np.ones((1, 2, 4), np.float32),
                                   ())], jpath)
    ppath = str(tmp_path / "port.log")
    _log(Controller, [M.set_plan(slots, np.ones((1, 2, 4), np.float32),
                                 ())], ppath)
    with open(jpath) as a, open(ppath) as b:
        ja, pb = json.loads(a.read()), json.loads(b.read())
    ja.pop("seq"), pb.pop("seq")             # a per-process counter
    assert ja == pb                          # numpy payloads: the same record


def _serve_with_draft_swap(device, path=None, controller=None):
    """A spec:draft engine serving two prompts; after a tick, an
    ``update(draft_params=...)`` carrying the negated draft as bf16
    tensors on ``device`` (the garbage hot swap of the reference's
    examples/serve_batched.py).  Returns (outputs, engine, the swapped-in
    draft)."""
    cfg = get_arch(ARCH)
    params = lm.init(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device)
    dcfg = small_draft_cfg(cfg)
    dparams = lm.init(dcfg, torch.Generator(device=device).manual_seed(1),
                      device=device)
    eng = ServeEngine(cfg, params, max_len=48, slots=2, prefill_chunk=4,
                      decode_chunk=2, spec_decode=True, draft_cfg=dcfg,
                      draft_params=dparams, device=device,
                      engine=Engine(durable_log=path, controller=controller))
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(1, cfg.vocab, (n,)).astype(np.int32),
                       max_new=10) for n in (5, 7)]
    garbage = {k: ({n: (-v).to(torch.bfloat16) for n, v in g.items()}
                   if isinstance(g, dict) else (-g).to(torch.bfloat16))
               for k, g in dparams.items()}
    eng.tick()
    if controller is None:
        eng.update(draft_params=garbage)
    eng.run_until_done()
    return np.stack([r.output() for r in reqs]), eng, garbage


def _draft_equal(eng, garbage):
    for k, g in garbage.items():
        pairs = g.items() if isinstance(g, dict) else [(None, g)]
        for n, v in pairs:
            got = eng.draft_params[k][n] if n is not None \
                else eng.draft_params[k]
            assert torch.equal(_bits(got.cpu()), _bits(v.cpu())), (k, n)


def _replay_draft_swap(tmp_path, device):
    path = str(tmp_path / "serve.log")
    ref, eng, garbage = _serve_with_draft_swap(device, path=path)
    _draft_equal(eng, garbage)
    del eng                                          # "crash"
    records = Controller.read_durable_log(path)
    assert [r.kind for r in records] == ["update"]
    w = records[0].payload["draft_params"]["embed"]
    assert w.dtype == torch.bfloat16 and w.device.type == "cpu"
    got, eng2, _ = _serve_with_draft_swap(
        device, controller=ReplayingController(records))
    np.testing.assert_array_equal(got, ref)
    _draft_equal(eng2, garbage)
    assert eng2.spec_arms["draft"]["ticks"] > 0


def test_serve_draft_swap_replays_bit_identical(tmp_path):
    _replay_draft_swap(tmp_path, "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tensor_payload_logged_and_replayed(cuda, rng, tmp_path):
    """Tensors on the card, bf16 and f32: logged without raising, read back
    with the same bits, and replayed into a graphed ``ServeEngine``."""
    for tdt in (torch.bfloat16, torch.float32):
        t = torch.as_tensor(_values(rng, "float32")).to(cuda, tdt)
        path = str(tmp_path / f"{tdt}.log")
        _, warned = _log(Controller, [M.update(params={"w": t})], path)
        assert not warned
        (rec,) = Controller.read_durable_log(path)
        got = rec.payload["params"]["w"]
        assert got.dtype == tdt and torch.equal(_bits(got),
                                                _bits(t.cpu()))
    _replay_draft_swap(tmp_path, str(cuda))
