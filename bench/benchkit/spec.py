"""The files of a cell, found by the names ``BENCHMARK.json`` gives.

``root`` is the directory that holds ``BENCHMARK.json`` and ``bench/``:

* a configuration: ``configs[name]["file"]`` (a JSON object; its
  ``family`` names the reference ``bench/reference/<family>.py``);
* a traffic mix: ``bench/traffic/<mix>.json``;
* a metric's reader: ``bench/metrics/<name>.py``, or, for a name with a
  suffix after its first dot (``tick_ms.batch``), ``bench/metrics/<base>.py``
  when there is no file of the whole name.  A reader defines
  ``read(run) -> float | None``; ``run`` holds ``open`` and ``close``
  (the window, on the host's clock), ``ticks`` (the window's
  ``drive.TickRec``; a traced run's leave out the profiler's interval),
  ``sampled`` (the window's ``drive.Rec``), ``setup_s`` and ``trace``
  (``trace.read_events``' readings, or None).

So a cell, a configuration, a mix or a metric is added by adding files
and entries, and no file of the harness changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List


class Spec:
    def __init__(self, root):
        self.root = Path(root)
        self.bench_dir = self.root / "bench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.bench['workloads']]}")

    def config(self, name: str) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads(
            (self.bench_dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> List[Dict]:
        """The cell's metrics: its end-to-end ones without a trace, its
        per-layer ones with one (those whose ``workloads`` name the cell,
        or that have no ``workloads``)."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell in m.get("workloads", [cell])]

    def reader(self, name: str) -> Callable:
        d = self.bench_dir / "metrics"
        path = d / f"{name}.py"
        if not path.exists():
            path = d / f"{name.split('.', 1)[0]}.py"
        return _load(path, "bench_metric_" + path.stem.replace(".", "_")
                     .replace("-", "_")).read

    def reference(self, family: str):
        return _load(self.bench_dir / "reference" / f"{family}.py",
                     f"bench_reference_{family}")


def _load(path: Path, name: str):
    """The module of the file ``path`` (its imports resolve through
    ``sys.path``, where ``run.py`` puts ``bench/``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
