"""Each plain reference against the program's own CPU path at a tiny size:
the same bfloat16 weights (``weights.draw``) through the program's
``lm.forward`` (its plain torch versions of the kernels, bfloat16
activations) and through the reference in float32.  And the reference
layout of every configuration the benchmark runs is the program's
parameter tree, name for name and shape for shape."""
import json

import numpy as np
import pytest
import torch

import bench_tiny
from bench_tiny import torch_cpu  # noqa: F401 (fixture)
from benchkit import model, weights
from benchkit.spec import Spec
from reference._plain import f32_mm, fp8_mm

SPEC = Spec(bench_tiny.BENCH.parent)


@pytest.mark.parametrize("name", sorted(bench_tiny.TINY_CONFIGS))
@pytest.mark.parametrize("seed", [3, 2 ** 40 + 9])
def test_reference_matches_program_decode(name, seed):
    """The program's decode step through its cache, one position at a
    time (as the serve engine runs it), against the reference's forward
    over the whole sequence."""
    from repro_torch.models import lm
    cfg = bench_tiny.TINY_CONFIGS[name]
    ref = SPEC.reference(cfg["family"])
    arch = model.arch_config(cfg)
    tree = weights.draw(ref.layout(cfg), seed, "cpu")
    model.check_layout(arch, weights.shapes(tree))
    toks = np.random.default_rng(seed).integers(0, cfg["vocab_size"], 24)
    with torch.no_grad():
        state = lm.init_cache(arch, 1, 32, device="cpu")
        prog = []
        for t in toks:
            logits, state = lm.decode_step(
                tree, state, torch.tensor([[int(t)]]), arch)
            prog.append(logits[0])
        prog = torch.stack(prog)
        want = ref.logits(tree, [toks], [0], cfg, f32_mm)[0]
    err = (prog - want).abs().amax(-1)
    # bfloat16 activations through two layers: a few bf16 ulps of a logit
    # of scale 1 at every position
    assert (err <= 0.08 * want.std()).all(), err
    # the lower precision's control parts from the reference further
    with torch.no_grad():
        ctl = ref.logits(tree, [toks], [0], cfg, fp8_mm)[0]
    assert (ctl - want).abs().amax(-1).median() > 2 * err.median()


@pytest.mark.parametrize("cfg_name", ["yi-34b"])
def test_benchmark_configs_match_the_program_layout(cfg_name):
    cfg = SPEC.config(cfg_name)
    ref = SPEC.reference(cfg["family"])
    layout = ref.layout(cfg)

    def walk(t, prefix=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, prefix + (k,))
            else:
                yield prefix + (k,), tuple(v[0])
    model.check_layout(model.arch_config(cfg), dict(walk(layout)))


def test_config_files_hold_their_catalog_keys():
    bj = json.loads((bench_tiny.BENCH.parent / "BENCHMARK.json").read_text())
    for c in bj["configs"]:
        cfg = SPEC.config(c["name"])
        assert cfg["name"] == c["name"]
        assert (bench_tiny.BENCH.parent / c["file"]).exists()
        for k in c["reduced"]:
            assert k in cfg, k
