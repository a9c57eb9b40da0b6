"""The port's config registry against the JAX package's: every one of the
reference's eleven configs, full size and ``-smoke``, field by field, and
the parameter tree ``model_defs`` declares for it (keys and shapes; nothing
is allocated)."""
import dataclasses

import pytest

from repro.configs import get_arch as j_get_arch
from repro.configs.registry import _MODULES as J_MODULES
from repro.models import lm as j_lm
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.models import lm
from repro_torch.models.params import ParamDef

ARCHS = sorted(J_MODULES)


def test_registry_holds_every_reference_config():
    assert sorted(ARCH_IDS) == ARCHS


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    name = arch + "-smoke" if smoke else arch
    assert dataclasses.asdict(get_arch(name)) == \
        dataclasses.asdict(j_get_arch(name))


def _shapes(tree, leaf):
    if isinstance(tree, dict):
        return {k: _shapes(v, leaf) for k, v in tree.items()}
    return tuple(tree.shape) if leaf(tree) else tree


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_defs_match_reference_tree(arch, smoke):
    name = arch + "-smoke" if smoke else arch
    ref = j_lm.model_defs(j_get_arch(name))
    got = lm.model_defs(get_arch(name))
    is_def = lambda d: hasattr(d, "shape") and hasattr(d, "init")  # noqa
    assert _shapes(got, lambda d: isinstance(d, ParamDef)) == \
        _shapes(ref, is_def)


def test_qwen3_moe_projects_a_wider_q_than_d_model():
    """qwen3-moe-235b-a22b: 64 query heads of 128 (a q dim of 8192) against
    a d_model of 4096, 16 query heads a KV head."""
    cfg = get_arch("qwen3-moe-235b-a22b")
    defs = lm.model_defs(cfg)["moe"]
    assert defs["wq"].shape == (94, 4096, 8192)
    assert defs["wo"].shape == (94, 8192, 4096)
    assert defs["wk"].shape == (94, 4096, 512)
    assert cfg.hd == 128 and cfg.n_heads // cfg.n_kv_heads == 16
    assert defs["w_gate"].shape == (94, 144, 4096, 1536)
