"""The check catches a broken timed path: each fault a serving cell can
have is planted in the program underneath a whole tiny run on the CPU
(the harness's look for a card skipped), and ``correct`` comes out
false.  The faults: a token altered where it is produced; a step that
leaves its state (the KV cache) unchanged; half of the batch left out
(the upper half of the rows given the lower half's logits)."""
import importlib.util
import time

import pytest

import bench_tiny
from bench_tiny import torch_cpu  # noqa: F401 (fixture)
from benchkit.spec import Spec
from repro_torch.engine import serve as engine_serve
from repro_torch.models import blocks, lm

_spec = importlib.util.spec_from_file_location("bench_run_faults",
                                               bench_tiny.BENCH / "run.py")
bench_run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_run)


def _altered_token(monkeypatch):
    orig = engine_serve.sample_rows

    def sample_rows(logits, greedy, temps, gens):
        return (orig(logits, greedy, temps, gens) + 1) % logits.shape[-1]
    monkeypatch.setattr(engine_serve, "sample_rows", sample_rows)


def _state_unchanged(monkeypatch):
    orig = blocks._decode_attention

    def decode_attention(cfg, p, x, cache, ctx, *a, **kw):
        return orig(cfg, p, x, {k: v.clone() for k, v in cache.items()},
                    ctx, *a, **kw)
    monkeypatch.setattr(blocks, "_decode_attention", decode_attention)


def _half_batch(monkeypatch):
    orig = lm.decode_step

    def decode_step(*a, **kw):
        logits, st = orig(*a, **kw)
        h = logits.shape[0] // 2
        if h:
            logits = logits.clone()
            logits[h:2 * h] = logits[:h]
        return logits, st
    monkeypatch.setattr(lm, "decode_step", decode_step)


FAULTS = {"altered_token": _altered_token,
          "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", sorted(bench_tiny.CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = bench_run.run_cell(Spec(root), cell, 2 ** 31 + 23, 1.0, False,
                             device="cpu", t0=time.perf_counter())
    (_, got), = out["compared"].items()
    assert not out["correct"], got
    assert got["value"] > got["limit"]
