"""The control: the reference put in the program's place at the step below
the configuration's bfloat16 (float8 e4m3 products) must come out as not
correct.  On the CPU at a tiny size, and on the card at each cell's own
size on three seeds (``-m cuda``)."""
import importlib.util
import time

import pytest

import bench_tiny
from bench_tiny import card, torch_cpu  # noqa: F401 (fixtures)
from benchkit.spec import Spec

_spec = importlib.util.spec_from_file_location("bench_run_control",
                                               bench_tiny.BENCH / "run.py")
bench_run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_run)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("seed", [1000, 1001, 2 ** 31 + 5])
def test_control_fails_where_the_program_passes_tiny(root, seed):
    out = bench_run.run_cell(Spec(root), "tiny-llama.closed", seed, 1.0,
                             False, device="cpu", control=True,
                             t0=time.perf_counter())
    got = out["compared"]["logit_gap"]
    assert got["value"] <= got["limit"] < out["readings"]["control_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["yi-34b.batch"])
def test_control_fails_at_the_cell_size(card, cell):
    bench_run._caches(bench_tiny.BENCH.parent)
    spec = Spec(bench_tiny.BENCH.parent)
    for seed in (11, 2 ** 31 + 12, 2 ** 33 + 13):
        out = bench_run.run_cell(spec, cell, seed, 20.0, False,
                                 control=True, t0=time.perf_counter())
        (number, got), = out["compared"].items()
        control = out["readings"][number.replace("logit", "control")]
        assert got["value"] <= got["limit"] < control, out
