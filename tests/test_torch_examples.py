"""The port's four entry points, ``examples/torch_*.py``, run on the CPU at
their smoke configurations (``--device cpu``), each in a process of its
own, all four at once; each must exit 0 and print the result the
reference's example prints:

* ``torch_interactive_control.py``: post-recovery params identical to the
  uninterrupted run, ``True``;
* ``torch_serve_batched.py``: the outputs under the garbage draft are the
  static loop's, the draft swap's tensors read back from the durable log
  bit for bit, and both traffic classes served;
* ``torch_train_moe_reshape.py``: Reshape fires and the loss trajectory
  prints;
* ``torch_quickstart.py``: a finite loss and 2 x 8 generated tokens.

No ``examples/torch_*.py`` imports ``repro`` or ``jax``, and without a card
an example fails loudly unless ``--device cpu`` is given.
"""
import ast
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
# the CPU runs' arguments: smoke sizes, a short distillation and run
ARGS = {"torch_quickstart": [],
        "torch_interactive_control": [],
        "torch_serve_batched": ["--distill-steps", "30"],
        "torch_train_moe_reshape": ["--steps", "10"]}
LIMIT_S = 240


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


@pytest.fixture(scope="module")
def runs():
    """Every example started at once; {name: (returncode, stdout)}."""
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"),
         "--device", "cpu", *args], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, args in ARGS.items()}
    out = {}
    try:
        for name, p in procs.items():
            text, _ = p.communicate(timeout=LIMIT_S)
            out[name] = (p.returncode, text)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _ok(runs, name):
    rc, text = runs[name]
    assert rc == 0, text[-3000:]
    return text


def test_interactive_control_recovers_bit_identical(runs):
    text = _ok(runs, "torch_interactive_control")
    assert "post-recovery params identical to uninterrupted run: True" \
        in text
    assert "[user] paused at (step, microbatch)=" in text
    assert "breakpoints hit: ['token-budget']" in text
    assert "lr_scale now 0.3" in text


def test_serve_batched_draft_swap_and_classes(runs):
    text = _ok(runs, "torch_serve_batched")
    assert "outputs unchanged under the garbage draft: True" in text
    assert re.search(r"durable log: \[\('update', \d+\)\]; the swap's "
                     r"embed read back as torch.float32 \(\d+, \d+\), "
                     r"bit-equal: True", text), text[-2000:]
    assert "both traffic classes served: {'hi': True, 'lo': True}" in text
    assert "stream finished under control" in text
    assert "all 4/4 requests finished" in text
    assert "exact repeat answered from the result cache (1 hit" in text


def test_train_moe_reshape_fires(runs):
    text = _ok(runs, "torch_train_moe_reshape")
    m = re.search(r"reshape: (\d+) mitigation iterations", text)
    assert m and int(m.group(1)) > 0, text[-2000:]
    a, b = map(float, re.search(r"loss ([\d.]+) -> ([\d.]+)",
                                text).groups())
    assert math.isfinite(a) and math.isfinite(b)


def test_quickstart_trains_and_serves(runs):
    text = _ok(runs, "torch_quickstart")
    loss = float(re.search(r"loss=([\d.]+)", text).group(1))
    assert math.isfinite(loss)
    gen = ast.literal_eval(re.search(r"generated: (\[.*\])", text).group(1))
    assert len(gen) == 2 and all(len(row) == 8 for row in gen)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_examples_import_neither_repro_nor_jax():
    assert {p.stem for p in EXAMPLES} == set(ARGS)
    for path in EXAMPLES:
        roots = {name.split(".")[0] for name in _imports(path)}
        assert not roots & {"repro", "jax", "jaxlib"}, (path.name, roots)
        assert "repro_torch" in roots


def test_examples_fail_loudly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples run on it")
    p = subprocess.run([sys.executable,
                        str(ROOT / "examples" / "torch_quickstart.py")],
                       cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=LIMIT_S)
    assert p.returncode != 0
    assert "--device cpu" in p.stderr
    assert "generated" not in p.stdout
