"""Checkpointing substrate (the JAX package's ``checkpoint/checkpointer.py``
over torch state trees): pickled host-numpy snapshots (pickle
protocol 4 — self-describing and dependency-free; a msgpack+raw-numpy
container would be a format swap behind the same API) with fsynced atomic
publish, retention, an append-only ack manifest, and the Amber
control-replay log (paper §2.6.2) — recovery = restore + deterministic
replay of logged control messages.

Checkpointing is two regions (the Maestro split in
``engine.jobs.snapshot_workflow`` / ``persist_workflow``):

* **snapshot** — device→host copy of the state tree plus the control log.
  Blocking but cheap: one device sync, no I/O.  The payload it returns is
  immutable from the trainer's point of view, so the training step after it
  may freely update device state.
* **persist** — host→disk serialization, the expensive part.
  ``persist_async`` runs it on a single worker thread (persists stay
  serialized in submission order, so acks land in order), overlapped with
  the next training step; ``wait()`` is the completion barrier that
  re-raises worker errors.

Durability discipline (the durable-log barrier): the payload bytes are
fsynced *before* the atomic rename publishes them, the directory entry is
fsynced after, and only then is the step acknowledged in the append-only
``MANIFEST.log`` (each ack line itself fsynced).  ``restore`` only
considers acknowledged steps — a crash mid-``persist`` leaves at worst an
orphaned tmp file or an unacknowledged checkpoint, and recovery falls back
to the previous acknowledged step and replays the control log from there
(§2.6.2).  Recovery can therefore never see a checkpoint the log does not
acknowledge, and never a torn one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.messages import LogRecord


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and (named) tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def to_numpy_tree(tree):
    """Host numpy copies of a state tree with one device sync: every CUDA
    leaf is copied into its own pinned host buffer without blocking, then
    the device is synchronised once.  A leaf that is already on the host is
    copied too (np.array), so the payload never aliases live state that
    the next step may change."""
    pending = []

    def start(x):
        if torch.is_tensor(x) and x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x.detach(), non_blocking=True)
            pending.append(host)
            return host
        if torch.is_tensor(x):
            return np.array(x.detach().numpy())
        return np.array(x)

    out = _map(start, tree)
    if pending:
        torch.cuda.synchronize()
    return _map(lambda x: x.numpy() if torch.is_tensor(x) else x, out)


def to_device_tree(tree, device):
    """A restored numpy state tree -> tensors on ``device``."""
    return _map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


class Checkpointer:
    MANIFEST = "MANIFEST.log"

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._worker = None            # lazy single persist thread
        self._pending: List[Any] = []  # outstanding persist futures
        self._lock = threading.Lock()

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.pkl")

    def _manifest(self) -> str:
        return os.path.join(self.dir, self.MANIFEST)

    def _fsync_dir(self) -> None:
        fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    # ------------------------------------------------------- snapshot region
    def snapshot(self, step: int, state: Any,
                 control_log: Optional[List[LogRecord]] = None,
                 extra: Optional[Dict] = None) -> Dict:
        """Blocking device→host capture: one device sync, no I/O.  The
        returned payload is decoupled from device state — the next train
        step may mutate params/opt state while this payload persists."""
        return {
            "step": int(step),
            "state": to_numpy_tree(state),
            "control_log": [dataclasses.asdict(r) for r in control_log or []],
            "extra": extra or {},
        }

    # -------------------------------------------------------- persist region
    def persist(self, payload: Dict) -> str:
        """Host→disk: serialize, fsync the bytes, publish atomically, fsync
        the directory entry, THEN acknowledge the step in the manifest.
        Every state transition a crash can interrupt leaves ``restore`` a
        consistent previous step to fall back to."""
        step = payload["step"]
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f, protocol=4)
            f.flush()
            os.fsync(f.fileno())       # bytes durable BEFORE the rename
        os.replace(tmp, path)          # atomic publish
        self._fsync_dir()              # ...and the rename itself
        self._ack(step)                # durable-log barrier: now restorable
        self._gc()
        return path

    def persist_async(self, payload: Dict, on_done=None):
        """Queue ``persist`` on the worker thread and return its future.
        ``on_done(seconds)`` (optional) receives the measured persist wall
        time — the engine feeds it into the ``ckpt_persist`` cost EMA so
        the scheduler prices the overlapped region from measurement."""
        import time as _time

        def work():
            t0 = _time.perf_counter()
            path = self.persist(payload)
            if on_done is not None:
                on_done(_time.perf_counter() - t0)
            return path

        if self._worker is None:
            from concurrent.futures import ThreadPoolExecutor
            self._worker = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-persist")
        fut = self._worker.submit(work)
        with self._lock:
            self._pending.append(fut)
        return fut

    def wait(self) -> None:
        """Barrier: block until every outstanding persist has landed (and
        re-raise any worker-side error here, on the caller's thread)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def save(self, step: int, state: Any,
             control_log: Optional[List[LogRecord]] = None,
             extra: Optional[Dict] = None) -> str:
        """Blocking save: snapshot + persist in one call (the legacy API
        and the async path's measured baseline)."""
        return self.persist(self.snapshot(step, state, control_log, extra))

    # ---------------------------------------------------------- ack manifest
    def _ack(self, step: int) -> None:
        with open(self._manifest(), "a") as f:
            f.write(json.dumps({"step": int(step)}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def acked_steps(self) -> Optional[set]:
        """Acknowledged steps, or None when no manifest exists (a legacy
        directory: every published file is trusted, pre-barrier behavior)."""
        path = self._manifest()
        if not os.path.exists(path):
            return None
        out = set()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.add(int(json.loads(line)["step"]))
                except (ValueError, KeyError):
                    continue           # torn trailing ack line: not acked
        return out

    # ------------------------------------------------------------- retention
    def _gc(self):
        ckpts = sorted(self.list_steps())
        for s in ckpts[: -self.keep]:
            os.remove(self._path(s))

    def list_steps(self) -> List[int]:
        """Published checkpoint steps (acknowledged or not).  The step is
        the full stem between ``ckpt_`` and ``.pkl`` — filenames are
        zero-padded to 8 digits but steps >= 10**8 legitimately run longer,
        so a fixed slice would silently mis-parse them."""
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".pkl"):
                stem = f[len("ckpt_"):-len(".pkl")]
                if stem.isdigit():
                    out.append(int(stem))
        return sorted(out)

    def restorable_steps(self) -> List[int]:
        """Published AND acknowledged steps — the restore candidates."""
        steps = self.list_steps()
        acked = self.acked_steps()
        if acked is None:
            return steps
        return [s for s in steps if s in acked]

    def latest_step(self) -> Optional[int]:
        steps = self.restorable_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None):
        """Load a checkpoint payload.  With no explicit ``step``, candidates
        are tried newest-acknowledged first and a payload that fails to
        deserialize (torn by byte-level corruption despite the fsync
        discipline) falls back to the next older one — recovery always gets
        the newest checkpoint that is both acknowledged and readable."""
        if step is not None:
            return self._load(self._path(step))
        for s in reversed(self.restorable_steps()):
            try:
                return self._load(self._path(s))
            except (OSError, pickle.UnpicklingError, EOFError, ValueError,
                    KeyError):
                continue
        return None

    def _load(self, path: str):
        with open(path, "rb") as f:
            payload = pickle.load(f)
        payload["control_log"] = [LogRecord(**r)
                                  for r in payload["control_log"]]
        return payload
