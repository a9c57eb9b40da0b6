"""All-to-all expert parallelism (``moe_ffn_a2a``, ``layout="dp"``) over
``torch.distributed`` against the JAX package's ``moe_ffn_a2a``, and
against the port's own unsharded path.

The harness is ``tests/test_torch_sharded_moe.py``'s: the port under
``gloo`` on the CPU, one process a rank (world 2: ``data`` 1 x ``model``
2; world 4: 2 x 2), the reference's ``shard_map`` on forced host devices
in a process of its own, f32 inputs made with numpy from the suite's seed.
Each rank holds the rows ``idx * T_loc ...`` of the tokens, ``idx = data
row * |model| + model column``, as the reference's ``P(("data",
"model"))`` spec cuts them.

Held, with the fused gating and dispatch off and on, at a capacity factor
at which assignments drop (at the source's buckets and at the experts'):
the layer's gradients flow through its all-to-alls (finite, not all zero;
their values are ``tests/test_torch_mesh_train.py``'s);
y within the reference's dispatch tolerance (atol and rtol 1e-5,
``tests/test_moe_dispatch.py``); ``slot_counts``, ``kept_counts``,
``expert_counts`` and ``dropped`` equal.  The reference's a2a reports
every count over all ranks (its kept counts plus its drops make T k at
world 2 and 4: no count comes from one column alone, unlike
``moe_ffn_sharded``'s ``dropped``).  At a capacity factor where nothing
drops, the a2a layer gives the port's unsharded ``moe_ffn``'s y within
that tolerance and its integer metrics, and the ``layout="dp"`` forward
of ``olmoe-1b-7b-smoke`` (bf16, fused) on world 2 the unsharded forward's
logits and integer metrics.
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
from repro_torch.models import moe as moe_lib

ARCH = "olmoe-1b-7b-smoke"
T = 64
CAPACITY_FACTOR = 0.5
NO_DROP_FACTOR = 4.0        # cap_s >= T_loc k and cap2 >= T k at T 64
CASES = ("plain", "fused")
MESHES = {2: (1, 2), 4: (2, 2)}
FWD = (2, 16)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = dict(atol=1e-5, rtol=1e-5)
INTS = ("slot_counts", "kept_counts", "expert_counts", "dropped")


def case_cfg(case, cf=CAPACITY_FACTOR):
    cfg = get_arch(ARCH)
    fused = case == "fused"
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf, fused_gating=fused,
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
            f = jax.jit(lambda p, x, ps, pc: moe.moe_ffn_a2a(
                p, x, ps, pc, cfg, mesh, 0))
            y, m = f(p, a["x"], plan.slots[0], plan.cum[0])
            res[f"{case}/{world}/y"] = np.asarray(y)
            for k, v in m.items():
                res[f"{case}/{world}/{k}"] = np.asarray(v)
    np.savez(out, **res)
''' % ARCH)


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.path.dirname(__file__), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, suite_seed):
    """The reference's results and the port's per rank, all processes
    started together."""
    tmp = tmp_path_factory.mktemp("a2a_moe")
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
                 "import sys, test_torch_a2a_moe as t; "
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


def _layer(a, cfg, mesh, x_rows):
    """This rank's slots of the layer and its rows of x."""
    p = {"router": torch.from_numpy(a["router"])}
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = moe_lib.local_experts(torch.from_numpy(a[k]), cfg,
                                     mesh).contiguous()
    return p, torch.from_numpy(a["x"][x_rows])[None]


def worker(rank, world, tmp, seed):
    """One rank: ``moe_ffn_a2a`` for every case at the dropping and at the
    no-drop capacity factor, and on world 2 the ``layout="dp"`` forward
    beside the unsharded one."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init_{world}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(MESHES[world], ("data", "model"), "cpu")
        mdl = MESHES[world][1]
        idx = mesh.get_local_rank("data") * mdl + \
            mesh.get_local_rank("model")
        t_loc = T // world
        rows = slice(idx * t_loc, (idx + 1) * t_loc)
        a = make_inputs(int(seed))
        out = {}
        for case in CASES:
            for tag, cf in (("", CAPACITY_FACTOR), ("nodrop/",
                                                    NO_DROP_FACTOR)):
                cfg = case_cfg(case, cf)
                plan = moe_lib.identity_plan(cfg, 1, device="cpu")
                p, x = _layer(a, cfg, mesh, rows)
                moe_lib.reset_collective_bytes()
                with torch.no_grad():
                    y, m = moe_lib.moe_ffn(p, x, plan.slots[0],
                                           plan.cum[0], cfg, 0, mesh=mesh,
                                           layout="dp")
                out[f"{tag}{case}/y"] = y[0].numpy()
                for k, v in m.items():
                    out[f"{tag}{case}/{k}"] = v[0].numpy()
                out[f"{tag}{case}/bytes"] = np.asarray(
                    [moe_lib.COLLECTIVE_BYTES[k] for k in (
                        "all_reduce", "all_gather", "all_to_all")])
            # the layer's gradients, through its all-to-alls
            cfg = case_cfg(case)
            plan = moe_lib.identity_plan(cfg, 1, device="cpu")
            p, x = _layer(a, cfg, mesh, rows)
            for v in (x, *p.values()):
                v.requires_grad_(True)
            y, m = moe_lib.moe_ffn(p, x, plan.slots[0], plan.cum[0], cfg, 0,
                                   mesh=mesh, layout="dp")
            (y.square().sum() + m["aux_loss"].sum() +
             m["router_z"].sum()).backward()
            for k, v in (("x", x), *p.items()):
                out[f"{case}/grad/{k}"] = v.grad.numpy()
        if world == 2:
            cfg = case_cfg("fused", NO_DROP_FACTOR)
            params = lm.init(cfg, torch.Generator().manual_seed(3),
                             device="cpu")
            tokens = torch.from_numpy(np.random.default_rng(5).integers(
                1, cfg.vocab, FWD))
            with torch.no_grad():
                got, aux = lm.forward(moe_lib.shard_experts(params, cfg,
                                                            mesh),
                                      {"tokens": tokens[idx:idx + 1]}, cfg,
                                      token_offset=0, mesh=mesh,
                                      layout="dp")
                want, aux0 = lm.forward(params, {"tokens": tokens}, cfg)
            out["fwd/got"] = got[0].numpy()
            out["fwd/want"] = want[idx].numpy()
            for k in INTS:
                out[f"fwd/{k}"] = aux["moe"][k].numpy()
                out[f"fwd0/{k}"] = aux0["moe"][k].numpy()
        np.savez(os.path.join(tmp, f"port_{world}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _rows_in_order(port, world, key):
    """Every rank's rows of ``key``, in the order of the flattened
    tokens (rank r is data row r // |model|, column r % |model|, and its
    flattened index is r)."""
    return np.concatenate([port[world][r][key] for r in range(world)])


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_a2a_matches_reference(runs, case, world):
    ref, port, _ = runs
    cfg = case_cfg(case)
    k, d = cfg.moe.top_k, cfg.d_model
    np.testing.assert_allclose(_rows_in_order(port, world, f"{case}/y"),
                               ref[f"{case}/{world}/y"], **TOL)
    kept = ref[f"{case}/{world}/kept_counts"]
    dropped = int(ref[f"{case}/{world}/dropped"])
    assert dropped > 0 and kept.sum() + dropped == T * k
    mdl = MESHES[world][1]
    t_loc = T // world
    cap_s = max(4, int(t_loc * k * CAPACITY_FACTOR / mdl))
    for r in range(world):
        got = port[world][r]
        for key in INTS:
            np.testing.assert_array_equal(got[f"{case}/{key}"],
                                          ref[f"{case}/{world}/{key}"])
        for key in ("aux_loss", "router_z"):
            np.testing.assert_allclose(got[f"{case}/{key}"],
                                       ref[f"{case}/{world}/{key}"],
                                       rtol=1e-5, atol=1e-7)
        # three all-to-alls of [|model| * cap_s] rows (x, slot ids, y),
        # one int and one f32 all-reduce of the metrics, no all-gather
        n_e, s = cfg.moe.num_experts, moe_lib.num_slots(cfg)
        np.testing.assert_array_equal(
            got[f"{case}/bytes"],
            [(s + n_e + 1) * 4 + (n_e + 1) * 4, 0,
             mdl * cap_s * (2 * d * 4 + 4)])


@pytest.mark.parametrize("world", list(MESHES))
@pytest.mark.parametrize("case", CASES)
def test_a2a_matches_unsharded_port(runs, case, world):
    """Nothing drops: the unsharded ``moe_ffn`` on all the tokens."""
    _, port, a = runs
    cfg = case_cfg(case, NO_DROP_FACTOR)
    plan = moe_lib.identity_plan(cfg, 1, device="cpu")
    p = {k: torch.from_numpy(v) for k, v in a.items() if k != "x"}
    y, m = moe_lib.moe_ffn(p, torch.from_numpy(a["x"])[None], plan.slots[0],
                           plan.cum[0], cfg, torch.zeros(1, dtype=torch.long))
    assert int(m["dropped"][0]) == 0
    np.testing.assert_allclose(
        _rows_in_order(port, world, f"nodrop/{case}/y"), y[0].numpy(),
        **TOL)
    for got in port[world]:
        assert int(got[f"nodrop/{case}/dropped"]) == 0
        for key in ("kept_counts", "expert_counts"):
            np.testing.assert_array_equal(got[f"nodrop/{case}/{key}"],
                                          m[key][0].numpy())


def test_dp_forward_matches_unsharded(runs):
    """olmoe-1b-7b-smoke's forward (bf16, fused gating and dispatch, a
    capacity factor at which nothing drops), one batch row a rank over
    ``data`` 1 x ``model`` 2: the unsharded forward's logits of that row
    and its integer metrics.  Both combine the same bf16 expert rows
    with f32 weights and round once, so the logits agree bit for bit."""
    _, port, _ = runs
    for got in port[2]:
        np.testing.assert_array_equal(got["fwd/got"], got["fwd/want"])
        for key in ("kept_counts", "dropped", "expert_counts"):
            np.testing.assert_array_equal(got[f"fwd/{key}"],
                                          got[f"fwd0/{key}"])


def test_a2a_gradients_flow_and_checks_the_layout(runs, suite_seed):
    """The layer is differentiable through its all-to-alls: on every rank
    of both worlds and in both cases, x's, the router's and the rank's
    slots' gradients of ``sum(y^2) + aux + z`` are finite and not all zero
    (their values are held to ``jax.grad`` of the reference's layer in
    ``tests/test_torch_mesh_train.py``); ``moe_ffn`` names its layouts."""
    _, port, _ = runs
    for world in MESHES:
        for got in port[world]:
            for case in CASES:
                for k in ("x", "router", "w_gate", "w_up", "w_down"):
                    g = got[f"{case}/grad/{k}"]
                    assert np.isfinite(g).all() and np.abs(g).max() > 0, \
                        (case, k)
    a = make_inputs(suite_seed)
    cfg = case_cfg("plain")
    plan = moe_lib.identity_plan(cfg, 1, device="cpu")
    p = {k: torch.from_numpy(v) for k, v in a.items() if k != "x"}
    x = torch.from_numpy(a["x"])[None]
    with pytest.raises(ValueError, match="layout"):
        moe_lib.moe_ffn(p, x, plan.slots[0], plan.cum[0], cfg, 0,
                        mesh=object(), layout="fsdp")
