"""Test support for the benchmark's CPU tests.

Tiny cells: a copy of ``bench/`` under a temporary root, with a
``BENCHMARK.json`` of its own, a tiny configuration and a tiny mix,
added as files and entries only.  Importing this
module puts ``src/`` on the path (``bench/`` is there already: pytest
puts a test file's directory first); ``torch_cpu`` is the tests' autouse
fixture (import it into a test module); ``card`` skips a test without a
CUDA device, decided when the test runs.  (No ``conftest.py`` here: the
tests under ``tests/`` import their own ``conftest`` by that name.)"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
if str(BENCH.parent / "src") not in sys.path:
    sys.path.insert(0, str(BENCH.parent / "src"))


@pytest.fixture(autouse=True)
def torch_cpu():
    """torch on one thread with oneDNN off for every test: parallel test
    workers oversubscribe the cores otherwise, and oneDNN's bf16 products
    round a row by the product's height, which moves near-tie tokens
    between the engine's tick layouts (as in ``tests/``)."""
    import torch
    n, mk = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(1)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mk


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")

TINY_CONFIGS = {
    "tiny-llama": {
        "name": "tiny-llama", "family": "llama", "source": "test",
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "vocab_size": 128, "rope_theta": 5e6, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": False,
        "check": {"limit": 0.05}},
}

TINY_MIXES = {
    "tiny-closed": {
        "clients": 8, "block": 8,
        "prompt_len": {"kind": "bounded_pareto", "lo": 4, "hi": 12,
                       "alpha": 1.2},
        "output_len": {"kind": "bounded_pareto", "lo": 16, "hi": 40,
                       "alpha": 1.2},
        "server": {"slots": 4, "max_len": 64}, "ladder": [1, 2],
        "warmup_s": 0.3, "drain_cap_s": 30, "trace_s": 0.3,
        "check": {"served_tokens": 160, "min_requests": 8,
                  "max_requests": 24}},
}

CELLS = {"tiny-llama.closed": ("tiny-llama", "tiny-closed")}


def make_root(tmp: Path) -> Path:
    """``tmp`` as a checkout's root: ``bench/`` copied, the tiny files
    added, and a ``BENCHMARK.json`` whose metrics are the real one's with
    each ``workloads`` list naming the tiny cell in place of the real."""
    shutil.copytree(BENCH, tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for name, cfg in TINY_CONFIGS.items():
        (tmp / "bench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
    for name, mix in TINY_MIXES.items():
        (tmp / "bench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    tiny_of = {"yi-34b.batch": "tiny-llama.closed"}
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_of[w] for w in m["workloads"]]
    real["configs"] = [{"name": n, "source": "test",
                        "file": f"bench/configs/{n}.json", "reduced": [],
                        "why": "test"} for n in TINY_CONFIGS]
    real["workloads"] = [{"name": c, "config": cf, "traffic": mx,
                          "chips": 1, "why": "test"}
                         for c, (cf, mx) in CELLS.items()]
    (tmp / "BENCHMARK.json").write_text(json.dumps(real))
    return tmp
