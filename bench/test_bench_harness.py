"""The harness end to end on the CPU at tiny sizes: a copy of ``bench/``
under a temporary root with tiny cells added as files and entries only;
every run prints the contract's keys, and the check holds the program's
served tokens to the reference."""
import importlib.util
import json
import time

import pytest
import torch

import bench_tiny
from bench_tiny import torch_cpu  # noqa: F401 (fixture)
from benchkit.spec import Spec

_spec = importlib.util.spec_from_file_location("bench_run",
                                               bench_tiny.BENCH / "run.py")
bench_run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench_run)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_tiny.make_root(tmp_path_factory.mktemp("root"))


def run_tiny(root, cell, seed=2 ** 31 + 11, seconds=1.0, trace=False):
    return bench_run.run_cell(Spec(root), cell, seed, seconds, trace,
                              device="cpu", t0=time.perf_counter())


@pytest.mark.parametrize("cell", sorted(bench_tiny.CELLS))
def test_tiny_cell_runs_correct(root, cell):
    out = run_tiny(root, cell)
    assert out.pop("diag")["first_done_s"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in Spec(root).metrics(cell, False)}
    assert set(out["metrics"]) == want and "setup_s" in want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


def test_traced_run_reports_host_metrics(root):
    out = run_tiny(root, "tiny-llama.closed", trace=True)
    names = set(out["metrics"])
    # no device here: the trace's metric finds nothing and stays out
    assert names == {"rows_per_tick.batch", "tick_ms.batch", "mfu.batch"}
    assert out["correct"]


def test_added_cell_config_mix_and_metric_are_found(root, tmp_path):
    """A later change adds a configuration, a mix, a metric and a cell as
    new files and new entries; the harness finds them by name."""
    new = bench_tiny.make_root(tmp_path)
    cfg = dict(bench_tiny.TINY_CONFIGS["tiny-llama"], name="tiny-llama-b",
               num_hidden_layers=1)
    mix = dict(bench_tiny.TINY_MIXES["tiny-closed"], clients=6,
               prompt_len={"kind": "bounded_pareto", "lo": 8, "hi": 20,
                           "alpha": 1.5})
    (new / "bench/configs/tiny-llama-b.json").write_text(json.dumps(cfg))
    (new / "bench/traffic/tiny-long.json").write_text(json.dumps(mix))
    (new / "bench/metrics/finished_count.py").write_text(
        "def read(run):\n"
        "    return sum(r.t_done is not None for r in run['sampled'])\n")
    bj = json.loads((new / "BENCHMARK.json").read_text())
    bj["configs"].append({"name": "tiny-llama-b", "source": "test",
                          "file": "bench/configs/tiny-llama-b.json",
                          "reduced": [], "why": "test"})
    bj["workloads"].append({"name": "tiny-llama-b.long",
                            "config": "tiny-llama-b",
                            "traffic": "tiny-long", "chips": 1,
                            "why": "test"})
    bj["per_layer"].append({"name": "finished_count.long", "unit": "req",
                            "better": "higher", "source": "host_clock",
                            "layer": "batching", "moves": "gen_tok_s",
                            "workloads": ["tiny-llama-b.long"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bj))
    e2e = run_tiny(new, "tiny-llama-b.long")
    assert set(e2e["metrics"]) == {"gen_tok_s", "setup_s"}
    traced = run_tiny(new, "tiny-llama-b.long", trace=True)
    assert set(traced["metrics"]) == {"finished_count.long"}
    # the run waits until the check's requests have finished
    assert 8 <= traced["metrics"]["finished_count.long"]["value"] <= \
        traced["attempted"]
    assert e2e["correct"] and traced["correct"]


def test_main_without_a_card_exits_without_result(monkeypatch, capsys):
    for k in ("REPRO_TORCH_BUILD_DIR", "TORCH_EXTENSIONS_DIR",
              "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(k, "unset")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "yi-34b.batch", "--seed", "1",
                         "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
