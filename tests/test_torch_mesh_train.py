"""The production training step over a ``torch.distributed`` mesh, and the
expert-parallel MoE layers' gradients.

Under ``gloo`` on the CPU, one process a rank (world 2: ``data`` 1 x
``model`` 2 in both layouts and ``data`` 2 x ``model`` 1; world 4: 2 x 2
in both layouts), as ``tests/test_torch_sharded_moe.py`` runs them:

* ``build_train_step`` of ``paper-moe-100m-smoke`` (fused gating and
  dispatch, a capacity factor at which nothing drops, 8 x 16 tokens in 2
  microbatches), each rank with its share of every microbatch
  (``shard_batch``) and its expert slots, against the unsharded step on
  the whole batch: the loss averaged over the batch's shards within the
  training gate (rtol 1e-3), the integer metrics equal, and each leaf's
  update within the gradient gate (relative L2 5e-2; the AdamW settings
  make the update the clipped gradient itself: eps 1e3 against gradients
  far below it, lr 1e3, no weight decay, the clip at norm 1 on, so a norm
  taken over one rank's experts alone would scale the update wrongly).
  Every rank's replicated leaves are equal bit for bit after the step.
* ``moe_ffn_sharded`` (``layout="tp"``) and ``moe_ffn_a2a`` (``"dp"``) of
  ``olmoe-1b-7b-smoke``, f32 inputs made with numpy from the suite's seed
  at a capacity factor at which assignments drop, fused gating and
  dispatch off and on: each rank differentiates ``sum(y * ct)`` plus its
  share of ``0.5 aux + 0.25 z``; the router's and experts' gradients
  summed over the ranks that share them and x's over its rows are held to
  ``jax.grad`` of the JAX package's ``shard_map`` layer on forced host
  devices (in a process of its own) within the dispatch tolerance (atol
  and rtol 1e-5).
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
from repro_torch.configs.base import ShapeCfg
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# the step: world -> the (data, model) meshes and layouts it runs
STEP_MESHES = {2: (((1, 2), "tp"), ((1, 2), "dp"), ((2, 1), "tp")),
               4: (((2, 2), "tp"), ((2, 2), "dp"))}
STEP_ARCH = "paper-moe-100m-smoke"
BATCH, SEQ, N_MB = 8, 16, 2
NO_DROP = 4.0
LOSS_RTOL, GRAD_RTOL = 1e-3, 5e-2
# the layer: world -> its (data, model) mesh
LAYER_MESHES = {2: (1, 2), 4: (2, 2)}
LAYER_ARCH = "olmoe-1b-7b-smoke"
T = 64
CAPACITY_FACTOR = 0.5
CASES = ("plain", "fused")
LAYOUTS = ("tp", "dp")
AUX, Z = 0.5, 0.25
TOL = dict(atol=1e-5, rtol=1e-5)
INTS = ("expert_counts", "slot_counts", "dropped")


def step_cfg():
    cfg = get_arch(STEP_ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=NO_DROP, fused_gating=True,
        fused_dispatch=True))


def step_hyper():
    from repro_torch.runtime.train import TrainHyper
    return TrainHyper(opt=adamw.AdamWCfg(lr=1e3, eps=1e3, weight_decay=0.0,
                                         warmup_steps=1))


def step_inputs():
    """The f32 state (weights from a seeded generator) and the global
    batch."""
    from repro_torch.runtime.train import make_state
    cfg = step_cfg()
    state = make_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab, (BATCH, SEQ)))
    return cfg, state, {"tokens": tokens}


def layer_cfg(case):
    cfg = get_arch(LAYER_ARCH)
    fused = case == "fused"
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPACITY_FACTOR, fused_gating=fused,
        fused_dispatch=fused))


def layer_inputs(seed):
    cfg = layer_cfg("plain")
    rng = np.random.default_rng(seed)
    d, e = cfg.d_model, cfg.moe.num_experts
    s, f = moe_lib.num_slots(cfg), cfg.moe.expert_d_ff
    return {"x": rng.standard_normal((T, d)).astype(np.float32),
            "ct": rng.standard_normal((T, d)).astype(np.float32),
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
    import jax.numpy as jnp
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
            for layout, fn in (("tp", moe.moe_ffn_sharded),
                               ("dp", moe.moe_ffn_a2a)):
                def loss(p, x, fn=fn, cfg=cfg, mesh=mesh):
                    y, m = fn(p, x, plan.slots[0], plan.cum[0], cfg, mesh, 0)
                    return jnp.sum(y * a["ct"]) + %r * m["aux_loss"] + \\
                        %r * m["router_z"]
                gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, a["x"])
                for k, v in gp.items():
                    res[f"{case}/{world}/{layout}/{k}"] = np.asarray(v)
                res[f"{case}/{world}/{layout}/x"] = np.asarray(gx)
    np.savez(out, **res)
''' % (LAYER_ARCH, AUX, Z))


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.path.dirname(__file__), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, suite_seed):
    """The reference's gradients, each rank's results and the unsharded
    step's, the processes all started together."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    np.savez(tmp / "in.npz", **layer_inputs(suite_seed))
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
         str(tmp / "ref.npz"), str(CAPACITY_FACTOR)],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    for world in STEP_MESHES:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import sys, test_torch_mesh_train as t; "
                 "t.worker(*sys.argv[1:])", str(rank), str(world),
                 str(tmp), str(suite_seed)],
                env=_env(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
    unsharded = unsharded_step()
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    port = {w: [torch.load(tmp / f"port_{w}_{r}.pt") for r in range(w)]
            for w in STEP_MESHES}
    return ref, port, unsharded


def unsharded_step():
    from repro_torch.runtime.train import build_train_step
    torch.set_num_threads(1)
    cfg, state, batch = step_inputs()
    plan = moe_lib.identity_plan(cfg, lm.n_moe_layers(cfg), device="cpu")
    step = build_train_step(cfg, ShapeCfg("t", SEQ, BATCH, "train", N_MB),
                            step_hyper())
    new, metrics = step(state, batch, plan.slots, plan.cum)
    return state["params"], new["params"], metrics


def worker(rank, world, tmp, seed):
    """One rank: the step on every mesh and layout of its world, then the
    layer's gradients in both layouts and cases."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init_{world}",
                            rank=rank, world_size=world)
    try:
        out = {}
        for shape, layout in STEP_MESHES[world]:
            out[f"step/{shape}/{layout}"] = mesh_step(
                make_mesh(shape, ("data", "model"), "cpu"), layout)
        mesh = make_mesh(LAYER_MESHES[world], ("data", "model"), "cpu")
        a = layer_inputs(int(seed))
        for case in CASES:
            for layout in LAYOUTS:
                out[f"layer/{case}/{layout}"] = layer_grads(
                    a, layer_cfg(case), mesh, layout)
        torch.save(out, os.path.join(tmp, f"port_{world}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def mesh_step(mesh, layout):
    """One ``build_train_step`` step of this rank's share: its new
    parameters and metrics."""
    from repro_torch.runtime.train import build_train_step, shard_batch
    cfg, state, batch = step_inputs()
    params = moe_lib.shard_experts(state["params"], cfg, mesh)
    state = {"params": params, "opt": adamw.init(params),
             "step": state["step"]}
    plan = moe_lib.identity_plan(cfg, lm.n_moe_layers(cfg), device="cpu")
    step = build_train_step(cfg, ShapeCfg("t", SEQ, BATCH, "train", N_MB),
                            step_hyper(), mesh, layout)
    new, metrics = step(state, shard_batch(batch, N_MB, mesh, layout),
                        plan.slots, plan.cum)
    return {"params": new["params"], "metrics": metrics,
            "data": mesh.get_local_rank("data"),
            "model": mesh.get_local_rank("model")}


def layer_grads(a, cfg, mesh, layout):
    """This rank's gradients of ``sum(y * ct) + (AUX aux + Z z) / n`` (n
    the ranks the rows are cut over): x's for its rows, the router's
    summed over those ranks, its slots' summed over ``data``."""
    import torch.distributed as dist
    dp, mdl = (mesh.shape[0], mesh.shape[1])
    row, col = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    n = dp * mdl if layout == "dp" else dp
    idx = row * mdl + col if layout == "dp" else row
    t_loc = T // n
    rows = slice(idx * t_loc, (idx + 1) * t_loc)
    p = {"router": torch.from_numpy(a["router"]).requires_grad_(True)}
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = moe_lib.local_experts(torch.from_numpy(a[k]), cfg, mesh) \
            .contiguous().requires_grad_(True)
    x = torch.from_numpy(a["x"][rows])[None].requires_grad_(True)
    plan = moe_lib.identity_plan(cfg, 1, device="cpu")
    y, m = moe_lib.moe_ffn(p, x, plan.slots[0], plan.cum[0], cfg, 0,
                           mesh=mesh, layout=layout)
    loss = (y[0] * torch.from_numpy(a["ct"][rows])).sum() + \
        (AUX * m["aux_loss"][0] + Z * m["router_z"][0]) / n
    loss.backward()
    out = {"x": x.grad[0], "rows": (idx * t_loc, (idx + 1) * t_loc),
           "data": row, "model": col}
    g = p["router"].grad.clone()
    if layout == "dp":
        dist.all_reduce(g)
    elif dp > 1:
        dist.all_reduce(g, group=mesh.get_group("data"))
    out["router"] = g
    for k in ("w_gate", "w_up", "w_down"):
        g = p[k].grad.clone()
        if dp > 1:
            dist.all_reduce(g, group=mesh.get_group("data"))
        out[k] = g
    return out


def _update(old, new):
    return [(b - a) for a, b in zip(tree_leaves(old), tree_leaves(new))]


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) /
                 max(float(torch.linalg.vector_norm(b.double())), 1e-30))


def _is_expert(path):
    return path[0] == "moe" and path[1] in ("w_gate", "w_up", "w_down")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        prefix + (k,))]
    return [prefix]


def _case_ids():
    return [f"{w}-{s[0]}x{s[1]}-{lay}" for w, ms in STEP_MESHES.items()
            for s, lay in ms]


@pytest.mark.parametrize("world,shape,layout", [
    (w, s, lay) for w, ms in STEP_MESHES.items() for s, lay in ms],
    ids=_case_ids())
def test_mesh_step_matches_unsharded(runs, world, shape, layout):
    _, port, (old, new, metrics) = runs
    ranks = [r[f"step/{shape}/{layout}"] for r in port[world]]
    loss = float(np.mean([float(r["metrics"]["loss"]) for r in ranks]))
    want = float(metrics["loss"])
    assert abs(loss - want) <= LOSS_RTOL * abs(want), (loss, want)
    for r in ranks:
        for key in INTS:
            np.testing.assert_array_equal(r["metrics"][key].numpy(),
                                          metrics[key].numpy(), err_msg=key)
    want = _update(old, new)
    for i, path in enumerate(_paths(new)):
        got = tree_leaves(ranks[0]["params"])[i]
        if _is_expert(path):
            # the model ranks of data row 0, in slot order
            parts = sorted((r["model"], tree_leaves(r["params"])[i])
                           for r in ranks if r["data"] == 0)
            assert len(parts) == shape[1]
            got = torch.cat([g for _, g in parts], 1)
        got = got - tree_leaves(old)[i]
        assert got.shape == want[i].shape, path
        assert _rel(got, want[i]) <= GRAD_RTOL, (path, _rel(got, want[i]))


@pytest.mark.parametrize("world,shape,layout", [
    (w, s, lay) for w, ms in STEP_MESHES.items() for s, lay in ms],
    ids=_case_ids())
def test_mesh_step_replicas_bit_equal(runs, world, shape, layout):
    """Every rank's replicated leaves, and the expert leaves of the ranks
    that hold the same slots, equal bit for bit after the step."""
    _, port, (_, new, _) = runs
    ranks = [r[f"step/{shape}/{layout}"] for r in port[world]]
    for i, path in enumerate(_paths(new)):
        for r in ranks[1:]:
            if _is_expert(path) and r["model"] != ranks[0]["model"]:
                continue
            assert torch.equal(tree_leaves(r["params"])[i],
                               tree_leaves(ranks[0]["params"])[i]), path


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("world", list(LAYER_MESHES))
@pytest.mark.parametrize("case", CASES)
def test_layer_grads_match_reference(runs, case, world, layout):
    ref, port, _ = runs
    key = f"{case}/{world}/{layout}"
    ranks = [r[f"layer/{case}/{layout}"] for r in port[world]]
    x = np.zeros_like(ref[f"{key}/x"])
    for r in ranks:
        assert torch.isfinite(r["x"]).all()
        x[r["rows"][0]:r["rows"][1]] = r["x"].numpy()
    np.testing.assert_allclose(x, ref[f"{key}/x"], **TOL)
    for r in ranks:
        np.testing.assert_allclose(r["router"].numpy(), ref[f"{key}/router"],
                                   **TOL)
    mdl = LAYER_MESHES[world][1]
    for k in ("w_gate", "w_up", "w_down"):
        parts = sorted((r["model"], r[k]) for r in ranks if r["data"] == 0)
        got = torch.cat([g for _, g in parts]).numpy()
        assert len(parts) == mdl
        np.testing.assert_allclose(got, ref[f"{key}/{k}"], **TOL)
