"""Expert-parallel MoE over ``torch.distributed`` against the JAX package's
``moe_ffn_sharded``, and against the port's own unsharded path.

The port runs under ``gloo`` on the CPU, one process a rank (world 2:
``data`` 1 x ``model`` 2; world 4: 2 x 2), with the fused gating and
dispatch off and on, at a capacity factor at which assignments drop.  The
reference runs its ``shard_map`` on a mesh of forced host devices, in a
process of its own (``XLA_FLAGS=--xla_force_host_platform_device_count=4``;
this suite's conftest strips ``XLA_FLAGS`` in the parent).  Inputs are f32,
made with numpy from the suite's seed and handed to both.

Held: the layer's gradients flow through its collectives (finite, not
all zero; their values are ``tests/test_torch_mesh_train.py``'s); y within
the reference's dispatch tolerance (atol and rtol 1e-5,
``tests/test_moe_dispatch.py``); ``slot_counts``, ``kept_counts`` and
``expert_counts`` equal; ``dropped`` equal to the drops the reference's own
kept counts imply (the reference's ``dropped`` is the first model column's
alone: its ``P()`` out spec takes one device's value of a count that
differs along ``model``).  With ``data`` 1 the port's unsharded ``moe_ffn``
must give the same y within that tolerance and the same kept counts,
drops and expert counts; and the sharded ``lm.forward`` of
``olmoe-1b-7b-smoke`` on world 2 the unsharded forward's logits.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib

ARCH = "olmoe-1b-7b-smoke"
T = 64
CAPACITY_FACTOR = 0.5
CASES = ("plain", "fused")
MESHES = {2: (1, 2), 4: (2, 2)}
FWD = (2, 16)                       # the sharded forward's batch
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = dict(atol=1e-5, rtol=1e-5)


def case_cfg(case):
    cfg = get_arch(ARCH)
    fused = case == "fused"
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPACITY_FACTOR, fused_gating=fused,
        fused_dispatch=fused))


def make_inputs(seed):
    cfg = case_cfg("plain")
    rng = np.random.default_rng(seed)
    d, e = cfg.d_model, cfg.moe.num_experts
    s, f = moe_lib.num_slots(cfg), cfg.moe.expert_d_ff
    return {"x": rng.standard_normal((T, d)).astype(np.float32),
            "router": rng.standard_normal((d, e)).astype(np.float32),
            "w_gate": (0.1 * rng.standard_normal((s, d, f))).astype(
                np.float32),
            "w_up": (0.1 * rng.standard_normal((s, d, f))).astype(
                np.float32),
            "w_down": (0.1 * rng.standard_normal((s, f, d))).astype(
                np.float32)}


REFERENCE = textwrap.dedent('''
    import dataclasses, sys
    import numpy as np
    import jax
    from repro.configs import get_arch
    from repro.models import moe
    src, out, cf = sys.argv[1], sys.argv[2], float(sys.argv[3])
    a = dict(np.load(src))
    res = {}
    for case in ("plain", "fused"):
        cfg = get_arch("%s")
        fused = case == "fused"
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf, fused_gating=fused,
            fused_dispatch=fused))
        plan = moe.identity_plan(cfg, 1)
        p = {k: a[k] for k in ("router", "w_gate", "w_up", "w_down")}
        for world, shape in ((2, (1, 2)), (4, (2, 2))):
            mesh = jax.make_mesh(shape, ("data", "model"))
            f = jax.jit(lambda p, x, ps, pc: moe.moe_ffn_sharded(
                p, x, ps, pc, cfg, mesh, 0))
            y, m = f(p, a["x"], plan.slots[0], plan.cum[0])
            res[f"{case}/{world}/y"] = np.asarray(y)
            for k, v in m.items():
                res[f"{case}/{world}/{k}"] = np.asarray(v)
    np.savez(out, **res)
''' % ARCH)


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.path.dirname(__file__), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **kw)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory, suite_seed):
    """The reference's results and the port's per rank, all processes
    started together."""
    tmp = tmp_path_factory.mktemp("sharded_moe")
    np.savez(tmp / "in.npz", **make_inputs(suite_seed))
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
         str(tmp / "ref.npz"), str(CAPACITY_FACTOR)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    for world in MESHES:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, test_torch_sharded_moe as t; "
                 "t.worker(*sys.argv[1:])", str(rank), str(world),
                 str(tmp), str(suite_seed)],
                env=_env(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    port = {w: [dict(np.load(tmp / f"port_{w}_{r}.npz")) for r in range(w)]
            for w in MESHES}
    return ref, port, make_inputs(suite_seed)


def worker(rank, world, tmp, seed):
    """One rank: ``moe_ffn_sharded`` for every case, and on world 2 the
    sharded ``lm.forward`` beside the unsharded one."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init_{world}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(MESHES[world], ("data", "model"), "cpu")
        a = make_inputs(int(seed))
        dp = MESHES[world][0]
        row = mesh.get_local_rank("data")
        t_loc = T // dp
        out = {}
        for case in CASES:
            cfg = case_cfg(case)
            plan = moe_lib.identity_plan(cfg, 1, device="cpu")
            p = {"router": torch.from_numpy(a["router"])}
            for k in ("w_gate", "w_up", "w_down"):
                p[k] = moe_lib.local_experts(torch.from_numpy(a[k]), cfg,
                                             mesh).contiguous()
            x = torch.from_numpy(a["x"][row * t_loc:(row + 1) * t_loc])[None]
            for v in (x, *p.values()):
                v.requires_grad_(True)
            moe_lib.reset_collective_bytes()
            y, m = moe_lib.moe_ffn_sharded(p, x, plan.slots[0], plan.cum[0],
                                           cfg, mesh, 0)
            out[f"{case}/y"] = y[0].detach().numpy()
            for k, v in m.items():
                out[f"{case}/{k}"] = v[0].detach().numpy()
            out[f"{case}/bytes"] = np.asarray(
                [moe_lib.COLLECTIVE_BYTES[k] for k in ("all_reduce",
                                                       "all_gather")])
            (y.square().sum() + m["aux_loss"].sum() +
             m["router_z"].sum()).backward()
            for k, v in (("x", x), *p.items()):
                out[f"{case}/grad/{k}"] = v.grad.numpy()
        if world == 2:
            cfg = case_cfg("fused")
            params = lm.init(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
            tokens = torch.from_numpy(np.random.default_rng(5).integers(
                1, cfg.vocab, FWD))
            with torch.no_grad():
                got, aux = lm.forward(moe_lib.shard_experts(params, cfg,
                                                            mesh),
                                      {"tokens": tokens}, cfg, mesh=mesh)
                want, aux0 = lm.forward(params, {"tokens": tokens}, cfg)
            out["fwd/got"], out["fwd/want"] = got.numpy(), want.numpy()
            for k in ("kept_counts", "dropped", "expert_counts"):
                out[f"fwd/{k}"] = aux["moe"][k].numpy()
                out[f"fwd0/{k}"] = aux0["moe"][k].numpy()
        np.savez(os.path.join(tmp, f"port_{world}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_reference(runs, case, world):
    ref, port, _ = runs
    dp, mdl = MESHES[world]
    k = case_cfg(case).moe.top_k
    y = np.concatenate([port[world][r * mdl][f"{case}/y"]
                        for r in range(dp)])
    np.testing.assert_allclose(y, ref[f"{case}/{world}/y"], **TOL)
    kept = ref[f"{case}/{world}/kept_counts"]
    assert kept.sum() < T * k                 # assignments do drop
    for r in range(world):
        got = port[world][r]
        for key in ("slot_counts", "kept_counts", "expert_counts"):
            np.testing.assert_array_equal(got[f"{case}/{key}"],
                                          ref[f"{case}/{world}/{key}"])
        assert int(got[f"{case}/dropped"]) == T * k - kept.sum()
        for key in ("aux_loss", "router_z"):
            np.testing.assert_allclose(got[f"{case}/{key}"],
                                       ref[f"{case}/{world}/{key}"],
                                       rtol=1e-5, atol=1e-7)
        # one all-reduce of this rank's rows [T_loc, D] (f32 partial sums),
        # plus the metrics' (ints over data; f32 router statistics over
        # data)
        n_e = case_cfg(case).moe.num_experts
        s = moe_lib.num_slots(case_cfg(case))
        y_bytes = (T // dp) * case_cfg(case).d_model * 4
        ints = (s // mdl + n_e + 1) * 4 if dp > 1 else 0
        stats = (n_e + 1) * 4 if dp > 1 else 0
        np.testing.assert_array_equal(got[f"{case}/bytes"],
                                      [y_bytes + ints + stats,
                                       (s // mdl + 1) * 4])


@pytest.mark.parametrize("case", CASES)
def test_sharded_matches_unsharded_port(runs, case):
    """data 1: the unsharded ``moe_ffn`` on the same rows and weights."""
    _, port, a = runs
    cfg = case_cfg(case)
    plan = moe_lib.identity_plan(cfg, 1, device="cpu")
    p = {k: torch.from_numpy(v) for k, v in a.items() if k != "x"}
    y, m = moe_lib.moe_ffn(p, torch.from_numpy(a["x"])[None], plan.slots[0],
                           plan.cum[0], cfg, torch.zeros(1, dtype=torch.long))
    for got in port[2]:
        np.testing.assert_allclose(got[f"{case}/y"], y[0].numpy(), **TOL)
        for key in ("kept_counts", "dropped", "expert_counts"):
            np.testing.assert_array_equal(got[f"{case}/{key}"],
                                          m[key][0].numpy())


def test_sharded_forward_matches_unsharded(runs):
    """olmoe-1b-7b-smoke's forward (bf16, fused gating and dispatch),
    experts over 2 ranks: the unsharded forward's logits and integer
    metrics bit for bit (each token's 2 assignments split over at most 2
    ranks, whose f32 partial sums add to the one-device f32 sum exactly,
    rounded once)."""
    _, port, _ = runs
    for got in port[2]:
        np.testing.assert_array_equal(got["fwd/got"], got["fwd/want"])
        for key in ("kept_counts", "dropped", "expert_counts"):
            np.testing.assert_array_equal(got[f"fwd/{key}"],
                                          got[f"fwd0/{key}"])


@pytest.mark.parametrize("case", CASES)
def test_sharded_gradients_flow(runs, case):
    """The layer is differentiable through its collectives: on every rank
    of both worlds, x's, the router's and the rank's slots' gradients of
    ``sum(y^2) + aux + z`` are finite and not all zero (their values are
    held to ``jax.grad`` of the reference's layer in
    ``tests/test_torch_mesh_train.py``)."""
    _, port, _ = runs
    for world in MESHES:
        for got in port[world]:
            for k in ("x", "router", "w_gate", "w_up", "w_down"):
                g = got[f"{case}/grad/{k}"]
                assert np.isfinite(g).all() and np.abs(g).max() > 0, k
