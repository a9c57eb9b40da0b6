"""The port's analytic model, roofline and sharding rules against the JAX
package's.

``analysis/flops.py`` is a copy, so every count must equal the
reference's exactly: parameter counts on all eleven configs at full width
and at smoke size (and the numel of ``lm.abstract``'s meta tree), step
FLOPs, step bytes per device and collective bytes per device for every
arch x shape on the meshes 16x16, 2x16x16, 1x1 and 1x4.  The sharding
rules must give the reference's specs leaf for leaf on those meshes (the
reference's functions read only ``mesh.shape`` and ``mesh.axis_names``, so
the port's plain ``Mesh`` stands in for a JAX mesh).  The roofline divides
by the H100's constants and by no TPU's.
"""
import math
import pathlib
import re

import jax
import pytest
import torch

from repro.analysis import flops as JF
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.models import lm as j_lm
from repro.runtime import sharding as JS
from repro_torch.analysis import flops as F
from repro_torch.analysis import roofline as RL
from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.launch import mesh as M
from repro_torch.models import lm
from repro_torch.runtime import sharding as S

MESHES = ("16x16", "2x16x16", "1x1", "1x4")
NAMES = [a for a in ARCH_IDS] + [a + "-smoke" for a in ARCH_IDS]


def _numel(tree):
    return sum(x.numel() for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("name", NAMES)
def test_param_count_matches_abstract_tree_and_reference(name):
    cfg = get_arch(name)
    params = lm.abstract(cfg)
    assert all(x.is_meta for x in jax.tree.leaves(params))
    n = F.param_count(cfg)
    assert n == _numel(params) == cfg.n_params()
    assert n == JF.param_count(j_get_arch(name))
    assert cfg.n_active_params() == JF.param_count(j_get_arch(name),
                                                    active_only=True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_counts_match_reference(arch):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    for sname, shape in SHAPES.items():
        jshape = J_SHAPES[sname]
        for remat in ("none", "full"):
            got = F.step_flops(cfg, shape, remat)
            want = JF.step_flops(jcfg, jshape, remat)
            assert (got.model_flops, got.hlo_flops) == \
                (want.model_flops, want.hlo_flops)
        for text in MESHES:
            mesh = S.parse_mesh(text)
            chips, m = mesh.devices, mesh.shape["model"]
            assert F.step_bytes_per_device(cfg, shape, chips, m) == \
                JF.step_bytes_per_device(jcfg, jshape, chips, m)
            for layout in ("tp", "dp"):
                assert F.collective_bytes_per_device(
                    cfg, shape, mesh.shape, layout=layout) == \
                    JF.collective_bytes_per_device(jcfg, jshape, mesh.shape,
                                                   layout=layout)
            rl = RL.analyze(cfg, shape, mesh.shape)
            assert rl.compute_s == rl.hlo_flops / (chips * 989e12)
            assert all(math.isfinite(t) and t > 0 for t in
                       (rl.compute_s, rl.memory_s))
            assert math.isfinite(rl.roofline_fraction)


def _same(ref, port) -> bool:
    """A reference ``PartitionSpec`` against a port spec; the reference
    writes a one-axis tuple as the axis's name."""
    def norm(e):
        return e[0] if isinstance(e, tuple) and len(e) == 1 else e
    return tuple(map(norm, ref)) == tuple(map(norm, port))


def _pairs(ref, port):
    """(reference spec, port spec) for every leaf of two spec trees."""
    if isinstance(port, dict):
        assert set(ref) == set(port)
        for k in port:
            yield from _pairs(ref[k], port[k])
    else:
        yield ref, port


@pytest.mark.parametrize("text", MESHES)
def test_specs_match_reference(text):
    """The baseline layout, and each of the reference's other layouts:
    no FSDP, the batch and activations over ``model`` too (``"dp"``),
    and the weight-stationary decode cache (``force_seq_shard``)."""
    mesh = S.parse_mesh(text)
    for arch in ARCH_IDS:
        cfg, jcfg = get_arch(arch), j_get_arch(arch)
        for fsdp in (True, False):
            pairs = list(_pairs(JS.param_specs(jcfg, mesh, fsdp=fsdp),
                                S.param_specs(cfg, mesh, fsdp=fsdp)))
            assert pairs and all(_same(r, p) for r, p in pairs)
        for sname, shape in SHAPES.items():
            for layout in ("tp", "dp"):
                jshape = J_SHAPES[sname]
                assert all(_same(r, p) for r, p in _pairs(
                    JS.batch_specs(jcfg, jshape, mesh, layout),
                    S.batch_specs(cfg, shape, mesh, layout)))
                assert _same(JS.act_spec_for(jcfg, jshape, mesh, layout),
                             S.act_spec_for(cfg, shape, mesh, layout))
            if shape.kind != "decode":
                continue
            j_cache = jax.eval_shape(lambda: j_lm.init_cache(
                jcfg, shape.global_batch, shape.seq_len))
            cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")
            for seq in (False, True):
                pairs = list(_pairs(
                    JS.cache_specs(jcfg, mesh, J_SHAPES[sname], j_cache,
                                   force_seq_shard=seq),
                    S.cache_specs(cfg, mesh, shape, cache,
                                  force_seq_shard=seq)))
                assert all(_same(r, p) for r, p in pairs)


def test_layout_options_reach_the_roofline():
    """``analyze``'s layout options give the reference's FLOPs, and each
    term equals the reference's once multiplied back by its own constant
    (the port divides by the H100's, the reference by a TPU's)."""
    from repro.analysis import roofline as JRL
    from repro.launch import mesh as JM
    opts = dict(fsdp=False, layout="dp", kv_bytes=1, seq_shard_decode=True)
    for arch in ("olmoe-1b-7b", "gemma3-1b", "zamba2-7b"):
        cfg, jcfg = get_arch(arch), j_get_arch(arch)
        for sname, shape in SHAPES.items():
            for text in ("2x16x16", "1x4"):
                mesh = S.parse_mesh(text)
                got = RL.analyze(cfg, shape, mesh.shape, **opts)
                want = JRL.analyze(jcfg, J_SHAPES[sname], mesh.shape, **opts)
                base = RL.analyze(cfg, shape, mesh.shape)
                assert (got.model_flops, got.hlo_flops) == \
                    (want.model_flops, want.hlo_flops)
                for term, mine, theirs in (
                        ("compute_s", M.PEAK_FLOPS_BF16,
                         JM.PEAK_FLOPS_BF16),
                        ("memory_s", M.HBM_BW, JM.HBM_BW),
                        ("collective_s", M.NVLINK_BW, JM.ICI_BW)):
                    assert getattr(got, term) * mine == pytest.approx(
                        getattr(want, term) * theirs, rel=1e-12), term
                if shape.kind == "decode":
                    assert got.memory_s < base.memory_s
                if shape.kind == "train" and mesh.devices > 1:
                    assert got.collective_s != base.collective_s


def test_all_cells_and_the_roofline_table():
    from repro.configs import all_cells as j_all_cells
    from repro_torch.configs import all_cells
    # the same cells and verdicts (the port words its reasons its own way)
    assert [c[:3] for c in all_cells()] == [c[:3] for c in j_all_cells()]
    assert len(list(all_cells())) == 40
    cfg = get_arch("paper-moe-100m")
    rl = RL.analyze(cfg, SHAPES["train_4k"], S.parse_mesh("1x4").shape)
    header, rule = RL.HEADER.split("\n")
    cols = header.count("|") - 1
    assert rule.count("|") - 1 == cols
    row = rl.row()
    assert row.count("|") - 1 == cols and row.startswith(
        "| paper-moe-100m | train_4k |")


def test_bytes_per_device_follow_the_specs():
    """A leaf's shard is its numel over the product of the axes that split
    it; optimizer moments share the parameters' specs."""
    cfg = get_arch("olmoe-1b-7b")
    mesh = S.parse_mesh("2x16x16")
    params = lm.abstract(cfg)
    specs = S.param_specs(cfg, mesh)
    w = params["moe"]["w_gate"]                      # [16, 80, 2048, 1024]
    assert specs["moe"]["w_gate"] == (None, "model", ("pod", "data"), None)
    assert S.shard_numel(w.shape, specs["moe"]["w_gate"], mesh) == \
        w.numel() // (16 * 32)
    one_mesh = S.parse_mesh("1x1")
    one = S.bytes_per_device(params, S.param_specs(cfg, one_mesh), one_mesh)
    assert one == 4 * cfg.n_params()
    total = S.bytes_per_device(params, specs, mesh)
    assert 4 * cfg.n_params() / 512 <= total < one
    opt = S.opt_state_specs(specs)
    assert opt.m is specs and opt.v is specs and opt.count == ()
    bf16 = lm.abstract(cfg, torch.bfloat16)
    assert S.bytes_per_device(bf16, specs, mesh) * 2 == total


def test_card_constants_are_the_h100s():
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.HBM_BYTES) == \
        (989e12, 3.35e12, 80e9)
    assert M.NVLINK_BW == 4.5e11
    # the reference's TPU v5e constants (its launch/mesh.py) appear nowhere
    # in the port
    root = pathlib.Path(M.__file__).parents[1]
    tpu = re.compile(r"(?<![\d.])(197e12|819e9|50e9)\b")
    assert not [p for p in root.rglob("*.py") if tpu.search(p.read_text())]
