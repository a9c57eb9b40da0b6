"""The dry run on the ``meta`` device: three cells, one of each kind of
step, traced at full width with nothing allocated (``MemTrace`` raises on
any tensor off ``meta``), each a PASS with finite roofline terms and the
state bytes its spec tree implies; the CLI's lines, JSON and exit code."""
import json
import math

import pytest
import torch

from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun
from repro_torch.runtime import sharding as S

CELLS = (("paper-moe-100m", "train_4k"), ("whisper-base", "prefill_32k"),
         ("rwkv6-1.6b", "long_500k"))
MESHES = [S.parse_mesh("1x1"), S.parse_mesh("1x4")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_passes_with_finite_terms(arch, shape):
    cfg, sh = get_arch(arch), SHAPES[shape]
    recs = dryrun.dry_cell(cfg, sh, MESHES)
    assert [r["mesh"] for r in recs] == ["1x1", "1x4"]
    one, four = recs
    for r in recs:
        terms = r["roofline"]
        assert r["ok"] and all(math.isfinite(terms[k]) and terms[k] > 0
                               for k in ("compute_s", "memory_s"))
        assert math.isfinite(terms["collective_s"]) and \
            (terms["collective_s"] > 0) == (r["mesh"] == "1x4")
        assert math.isfinite(r["roofline"]["roofline_fraction"])
        b = r["bytes_per_device"]
        assert b["transient"] > 0 and b["total"] == pytest.approx(
            sum(v for k, v in b.items() if k != "total"))
        assert 0 <= r["max_layers"] <= cfg.num_layers
        assert r["fits"] == (b["total"] <= 80e9)
        assert r["fits"] == (r["max_layers"] == cfg.num_layers)
    b1 = one["bytes_per_device"]
    n = cfg.n_params()
    if sh.kind == "train":
        assert (b1["params"], b1["optimizer"], b1["gradients"]) == \
            (4 * n, 8 * n, 4 * n)
    else:
        assert b1["params"] == 2 * n and b1["optimizer"] == 0
    assert (b1["cache"] > 0) == (sh.kind == "decode")
    assert four["bytes_per_device"]["total"] < b1["total"]


def test_cli_prints_pass_and_skip_and_writes_json(tmp_path, capsys):
    out = tmp_path / "d.json"
    rc = dryrun.main(["--arch", "paper-moe-100m", "--shape",
                      "decode_32k,long_500k", "--mesh", "1x1",
                      "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    assert "PASS paper-moe-100m x decode_32k x 1x1" in text
    assert "SKIP paper-moe-100m x long_500k x 1x1" in text
    recs = json.loads(out.read_text())
    assert [r["ok"] for r in recs] == [True, None]


def test_cli_reports_a_failed_cell(tmp_path, capsys, monkeypatch):
    def broken(cfg, shape, remat="none", kv_dtype=None):
        raise ValueError("shape mismatch")
    monkeypatch.setattr(dryrun, "trace_step", broken)
    rc = dryrun.main(["--arch", "paper-moe-100m", "--shape", "decode_32k",
                      "--mesh", "1x1", "--out", str(tmp_path / "d.json")])
    assert rc == 1
    assert "FAIL paper-moe-100m x decode_32k x 1x1: shape mismatch" in \
        capsys.readouterr().out


def test_layout_flags_reach_the_records(tmp_path, capsys):
    """``--kv-dtype f8`` halves a decode cell's attention-cache bytes and
    its roofline's cache traffic; ``--layout dp``, ``--force-seq-shard``
    and ``--microbatches`` reach the record, its specs and its terms."""
    def cell(*flags):
        out = tmp_path / "d.json"
        rc = dryrun.main(["--arch", "paper-moe-100m", "--shape",
                          "decode_32k", "--mesh", "2x2", "--out", str(out),
                          *flags])
        assert rc == 0
        (rec,) = json.loads(out.read_text())
        return rec

    bf16, f8 = cell(), cell("--kv-dtype", "f8")
    assert (bf16["kv_dtype"], f8["kv_dtype"]) == ("bf16", "f8")
    assert f8["bytes_per_device"]["cache"] * 2 == \
        bf16["bytes_per_device"]["cache"] > 0
    assert f8["bytes_per_device"]["params"] == \
        bf16["bytes_per_device"]["params"]
    assert f8["step_bytes_per_device"] < bf16["step_bytes_per_device"]
    assert (bf16["layout"], bf16["force_seq_shard"]) == ("tp", False)
    dp = cell("--layout", "dp", "--force-seq-shard")
    assert (dp["layout"], dp["force_seq_shard"]) == ("dp", True)
    assert dp["act_spec"] == [["data", "model"], None, None]
    assert dp["batch_specs"]["tokens"] == [["data", "model"], None]
    assert bf16["act_spec"] == [["data"], None, None]
    # weight-stationary decode: each device reads a quarter of the
    # weights, not the half of its 2 model ways
    assert dp["step_bytes_per_device"] < bf16["step_bytes_per_device"]
    assert dp["roofline"]["memory_s"] < bf16["roofline"]["memory_s"]
    (mb,) = dryrun.dry_cell(get_arch("paper-moe-100m"), SHAPES["train_4k"],
                            MESHES[:1], microbatches=4)
    (one,) = dryrun.dry_cell(get_arch("paper-moe-100m"), SHAPES["train_4k"],
                             MESHES[:1])
    assert (mb["microbatches"], one["microbatches"]) == \
        (4, SHAPES["train_4k"].microbatches)
    assert mb["bytes_per_device"]["transient"] != \
        one["bytes_per_device"]["transient"]


def test_recurrent_training_cells_pass(tmp_path, capsys):
    """A ``train`` cell of a recurrent config is not a SKIP: the CLI decides
    it by memory like every other cell (PASS), and ``dry_cell`` traces it
    through the scans' backward stand-ins."""
    rc = dryrun.main(["--arch", "rwkv6-1.6b,zamba2-7b", "--shape",
                      "train_4k", "--mesh", "1x1",
                      "--out", str(tmp_path / "d.json")])
    text = capsys.readouterr().out
    assert rc == 0
    for arch in ("rwkv6-1.6b", "zamba2-7b"):
        assert f"PASS {arch} x train_4k x 1x1" in text
        assert f"SKIP {arch} x train_4k" not in text
    recs = json.loads((tmp_path / "d.json").read_text())
    assert [r["ok"] for r in recs] == [True, True]
    (one,) = dryrun.dry_cell(get_arch("rwkv6-1.6b"), SHAPES["train_4k"],
                             MESHES[:1])
    n = get_arch("rwkv6-1.6b").n_params()
    b = one["bytes_per_device"]
    assert (b["params"], b["optimizer"]) == (4 * n, 8 * n)
    assert b["transient"] > 0


def _plain_and_fake(rng):
    """(plain version's outputs on the CPU, the dry run's stand-in's on
    ``meta``) for each kernel wrapper, on the same small inputs."""
    from repro_torch.kernels.mamba2_ssd.ref import (mamba2_bwd_ref,
                                                    mamba2_ref)
    from repro_torch.kernels.moe_dispatch.ref import combine_ref, dispatch_ref
    from repro_torch.kernels.moe_gating.ref import gating_ref
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_bwd_ref, rwkv6_ref

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape)).to(dtype)

    g, n_t, k, s, cap, d = 1, 8, 2, 4, 3, 16
    slot = torch.from_numpy(rng.integers(0, s, (g, n_t, k))).to(torch.int32)
    valid = torch.ones_like(slot)
    w = t(g, n_t, k)
    disp = dispatch_ref(t(g, n_t, d), w, slot, valid, s, cap)
    calls = {
        "gating": (gating_ref, dryrun._gating, (t(g, n_t, 6), k)),
        "dispatch": (dispatch_ref, dryrun._dispatch,
                     (t(g, n_t, d, dtype=torch.bfloat16), w, slot, valid, s,
                      cap)),
        "combine": (combine_ref, dryrun._combine,
                    (disp[0], w, slot, disp[1], disp[2])),
        "rwkv6": (rwkv6_ref, dryrun._rwkv6,
                  (*(t(1, 2, 5, 4) for _ in range(3)),
                   torch.rand(1, 2, 5, 4), t(2, 4))),
        "mamba2": (mamba2_ref, dryrun._mamba2,
                   (t(1, 2, 5, 3), torch.rand(1, 2, 5), -torch.rand(2),
                    t(1, 5, 4), t(1, 5, 4), t(2))),
        # the backwards with s0 / h0 given (their gradients returned too)
        "rwkv6_bwd": (rwkv6_bwd_ref, dryrun._rwkv6_bwd,
                      (*(t(1, 2, 5, 4, dtype=torch.bfloat16)
                         for _ in range(3)),
                       torch.rand(1, 2, 5, 4).to(torch.bfloat16), t(2, 4),
                       t(1, 2, 5, 4, dtype=torch.bfloat16), t(1, 2, 4, 4))),
        "mamba2_bwd": (mamba2_bwd_ref, dryrun._mamba2_bwd,
                       (t(1, 2, 5, 3, dtype=torch.bfloat16),
                        torch.rand(1, 2, 5), -torch.rand(2),
                        t(1, 5, 4, dtype=torch.bfloat16),
                        t(1, 5, 4, dtype=torch.bfloat16), t(2),
                        t(1, 2, 5, 3, dtype=torch.bfloat16),
                        t(1, 2, 3, 4))),
    }
    for name, (plain, fake, args) in calls.items():
        meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
        yield name, plain(*args), fake(*meta)


def test_stand_ins_make_the_wrappers_outputs():
    """Each stand-in gives the shapes and dtypes its kernel's plain version
    gives on the same inputs, on ``meta``; the wrappers and dispatchers
    are the card's again once ``meta_kernels`` closes."""
    import numpy as np
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe_gating import ops as mg
    for name, want, got in _plain_and_fake(np.random.default_rng(0)):
        assert [(tuple(x.shape), x.dtype) for x in want] == \
            [(tuple(x.shape), x.dtype) for x in got], name
        assert all(x.is_meta for x in got)
    q = torch.empty((2, 5, 4, 8), dtype=torch.bfloat16, device="meta")
    o, lse, o32 = dryrun._flash_fwd(q, q, q, keep_f32=True)
    assert (o.shape, o.dtype, o32.dtype) == (q.shape, q.dtype, torch.float32)
    assert tuple(lse.shape) == (2, 4, 5)
    before = (mg.resolve, mg.gating_cuda, fa.flash_fwd_cuda)
    with dryrun.meta_kernels():
        assert mg.resolve("auto", q) == "cuda"
        assert mg.gating_cuda is dryrun._gating
    assert (mg.resolve, mg.gating_cuda, fa.flash_fwd_cuda) == before
    assert mg.resolve("auto", q) == "torch"
    # the scans' backward stand-ins make their checkpoint scratch too, so
    # its bytes count in a trace's peak (outputs and scratch live at once)
    from repro_torch.kernels.mamba2_ssd.mamba2_ssd import \
        bwd_scratch as mamba2_scratch
    from repro_torch.kernels.rwkv6_scan.rwkv6_scan import \
        bwd_scratch as rwkv6_scratch
    r = torch.empty((1, 2, 70, 16), dtype=torch.bfloat16, device="meta")
    u = torch.empty((2, 16), device="meta")
    with dryrun.MemTrace() as mem:
        dryrun._rwkv6_bwd(r, r, r, r, u, r)
    assert mem.peak == 4 * r.numel() * 2 + 2 * 16 * 4 + sum(
        4 * math.prod(s) for s in rwkv6_scratch(1, 2, 70, 16).values())
    dt = torch.empty((1, 2, 70), device="meta")
    bm = torch.empty((1, 70, 16), dtype=torch.bfloat16, device="meta")
    a = torch.empty((2,), device="meta")
    with dryrun.MemTrace() as mem:
        dryrun._mamba2_bwd(r, dt, a, bm, bm, a, r)
    assert mem.peak == 2 * r.numel() + 4 * dt.numel() + 2 * 4 * 2 + \
        2 * 2 * bm.numel() + sum(4 * math.prod(s) for s in
                                 mamba2_scratch(1, 2, 70, 16, 16).values())


def test_production_meshes_reach_the_records(tmp_path, capsys):
    """``--mesh production,production2``: the H100 production mesh of one
    pod (32 nodes x 8 cards) and of two, priced as any mesh: each record
    names it, splits the weights over its cards and passes."""
    out = tmp_path / "d.json"
    rc = dryrun.main(["--arch", "paper-moe-100m", "--shape", "decode_32k",
                      "--mesh", "1x1,production,production2",
                      "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0
    for m in ("1x1", "32x8", "2x32x8"):
        assert f"PASS paper-moe-100m x decode_32k x {m}" in text
    one, prod, prod2 = json.loads(out.read_text())
    assert [r["mesh"] for r in (one, prod, prod2)] == ["1x1", "32x8",
                                                       "2x32x8"]
    assert one["bytes_per_device"]["params"] > \
        prod["bytes_per_device"]["params"] >= \
        prod2["bytes_per_device"]["params"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape(multi_pod):
    from repro_torch.launch import mesh as M
    m = M.production_mesh(multi_pod=multi_pod)
    if multi_pod:
        assert m.axis_names == ("pod", "data", "model")
        assert m.sizes == (2, 32, 8) and m.devices == 512
    else:
        assert m.axis_names == ("data", "model") and m.sizes == (32, 8)
    assert m.shape["model"] == M.NODE_CARDS == 8 and not m.group
    assert M.production_shape(multi_pod, nodes=1, per_node=2) == (
        ((2, 1, 2), ("pod", "data", "model")) if multi_pod
        else ((1, 2), ("data", "model")))


def _production_rank(rank, tmp):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=int(rank), world_size=2)
    try:
        mesh = make_production_mesh(nodes=1, per_node=2, device_type="cpu")
        x = torch.tensor([float(rank) + 1])
        dist.all_reduce(x, group=mesh.get_group("model"))
        print(json.dumps({"names": list(mesh.mesh_dim_names),
                          "shape": list(mesh.mesh.shape),
                          "model_rank": mesh.get_local_rank("model"),
                          "sum": x.item()}))
    finally:
        dist.destroy_process_group()


def test_make_production_mesh_over_gloo_ranks(tmp_path):
    """``make_production_mesh(nodes=1, per_node=2)`` over 2 gloo ranks on
    the CPU: one node of two cards, the ranks along ``model``, a sum over
    ``model`` reaching both."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([src, os.path.dirname(__file__),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_dryrun as t; "
         "t._production_rank(*sys.argv[1:])", str(r), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()[-3000:]
        outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    for r, o in enumerate(outs):
        assert o == {"names": ["data", "model"], "shape": [1, 2],
                     "model_rank": r, "sum": 3.0}
