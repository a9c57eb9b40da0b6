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
    def broken(cfg, shape):
        raise ValueError("shape mismatch")
    monkeypatch.setattr(dryrun, "trace_step", broken)
    rc = dryrun.main(["--arch", "paper-moe-100m", "--shape", "decode_32k",
                      "--mesh", "1x1", "--out", str(tmp_path / "d.json")])
    assert rc == 1
    assert "FAIL paper-moe-100m x decode_32k x 1x1: shape mismatch" in \
        capsys.readouterr().out


def test_recurrent_training_is_a_skip(tmp_path, capsys):
    """A ``train`` cell of a recurrent config is not a SKIP (the name is
    the one this test had when it pinned that SKIP, before the scan kernels
    had a backward): the CLI decides it by memory like every other cell
    (PASS), and ``dry_cell`` traces it through the scans' backward
    stand-ins."""
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
