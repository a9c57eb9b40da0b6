"""The Amber controller for the training/serving runtime.

The training loop plays the worker's DP thread: between *microbatches* (the
granulated iteration unit, §2.4.3) it calls ``poll()``, which drains the
mailbox, applies messages, and — when Paused — keeps serving Inspect /
Update / Resume messages *while paused* (§2.4.4), the capability Spark-style
engines lack.  Every applied message is appended to the control-replay log
with its (step, microbatch) point for deterministic recovery (§2.6.2).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.messages import ControlMessage, LogRecord


def _json_safe(x):
    """Durable-log encoding: tensors (any device, any dtype), numpy arrays
    and the small control-plane dataclasses (Migration) become tagged JSON
    values instead of raising TypeError — a dropped ``plan`` record
    silently breaks §2.6.2 recovery.  A tensor is copied to the host with
    its torch dtype and shape; bf16 and f16 go through f32, which holds
    them exactly, so ``_json_restore`` gives back the same bits."""
    import dataclasses as _dc

    import numpy as _np
    import torch as _torch
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, _np.integer):
        return int(x)
    if isinstance(x, _np.floating):
        return float(x)
    if isinstance(x, _torch.Tensor):
        t = x.detach().cpu()
        if t.dtype in (_torch.bfloat16, _torch.float16):
            t = t.float()
        return {"__tensor__": t.reshape(-1).tolist(),
                "dtype": str(x.dtype).removeprefix("torch."),
                "shape": list(x.shape)}
    if hasattr(x, "__array__") and not isinstance(x, (str, bytes)):
        a = _np.asarray(x)
        return {"__ndarray__": a.tolist(), "dtype": str(a.dtype)}
    if _dc.is_dataclass(x) and not isinstance(x, type):
        return {"__dataclass__": type(x).__name__,
                "fields": {f.name: _json_safe(getattr(x, f.name))
                           for f in _dc.fields(x)}}
    return x


def _json_restore(x):
    if isinstance(x, dict):
        if "__tensor__" in x:
            import torch as _torch
            dtype = getattr(_torch, x["dtype"])
            wide = _torch.float32 if dtype in (_torch.bfloat16,
                                               _torch.float16) else dtype
            return _torch.tensor(x["__tensor__"], dtype=wide).reshape(
                x["shape"]).to(dtype)
        if "__ndarray__" in x:
            import numpy as _np
            return _np.asarray(x["__ndarray__"], dtype=x["dtype"])
        if "__dataclass__" in x:
            from repro_torch.core import breakpoints as _bp
            from repro_torch.core import reshape_moe as _rm
            cls = getattr(_rm, x["__dataclass__"],
                          getattr(_bp, x["__dataclass__"], None))
            fields = {k: _json_restore(v) for k, v in x["fields"].items()}
            return cls(**fields) if cls is not None else fields
        return {k: _json_restore(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_json_restore(v) for v in x]
    return x


class Controller:
    def __init__(self):
        self.mailbox: "queue.Queue[ControlMessage]" = queue.Queue()
        self.paused = False
        self.stopped = False
        self.log: List[LogRecord] = []
        self.breakpoints: List[Any] = []
        self.config_updates: Dict[str, Any] = {}
        self.pending_plan: Optional[dict] = None
        self.pause_latency: List[float] = []     # wall-time send->effect
        self._sent_at: Dict[int, float] = {}
        self.durable_log_path: Optional[str] = None

    def attach_durable_log(self, path: str) -> None:
        """The coordinator's log survives worker crashes (§2.6.2 A1)."""
        self.durable_log_path = path

    @staticmethod
    def read_durable_log(path: str) -> List[LogRecord]:
        import json as _json
        import os as _os
        out: List[LogRecord] = []
        if not _os.path.exists(path):
            return out
        with open(path) as f:
            for line in f:
                d = _json.loads(line)
                d["payload"] = _json_restore(d["payload"])
                out.append(LogRecord(**d))
        return out

    # ------------------------------------------------------------ user side
    def send(self, msg: ControlMessage) -> ControlMessage:
        self._sent_at[msg.seq] = time.monotonic()
        self.mailbox.put(msg)
        return msg

    # ------------------------------------------------------------ loop side
    def _apply(self, msg: ControlMessage, step: int, microbatch: int,
               inspect_fn: Optional[Callable[[str], Any]]) -> None:
        rec = LogRecord(msg.kind, msg.payload, msg.seq, step, microbatch)
        self.log.append(rec)
        if self.durable_log_path and msg.kind in ("update", "plan", "pause",
                                                  "resume", "breakpoint"):
            import json as _json

            def line_of(payload):
                return _json.dumps({"kind": rec.kind, "payload": payload,
                                    "seq": rec.seq, "step": rec.step,
                                    "microbatch": rec.microbatch})
            try:
                line = line_of(_json_safe(rec.payload))
            except (TypeError, ValueError, RuntimeError) as e:
                # a payload _json_safe cannot encode (a type it does not
                # model, a tensor whose values cannot be read, such as one
                # on the meta device) must not kill the worker's poll, but
                # it must not vanish silently either: log a tagged repr
                # and warn — replay will surface it
                import warnings as _w
                line = line_of({"__unserializable__": repr(rec.payload)})
                _w.warn(f"durable log: {rec.kind} payload not "
                        f"JSON-serializable ({type(e).__name__}: {e}); "
                        f"logged as repr")
            with open(self.durable_log_path, "a") as f:
                f.write(line + "\n")
        if msg.kind == "pause":
            self.paused = True
            t0 = self._sent_at.pop(msg.seq, None)
            if t0 is not None:
                self.pause_latency.append(time.monotonic() - t0)
            msg.reply({"paused_at": (step, microbatch)})
        elif msg.kind == "resume":
            self.paused = False
            msg.reply({"resumed_at": (step, microbatch)})
        elif msg.kind == "inspect":
            msg.reply(inspect_fn(msg.payload) if inspect_fn else None)
        elif msg.kind == "update":
            self.config_updates.update(msg.payload)
            msg.reply(dict(self.config_updates))
        elif msg.kind == "breakpoint":
            self.breakpoints.append(msg.payload)
            msg.reply(len(self.breakpoints))
        elif msg.kind == "plan":
            self.pending_plan = msg.payload
            msg.reply(True)
        elif msg.kind == "stop":
            self.stopped = True
            self.paused = False
            msg.reply(True)

    def poll(self, step: int, microbatch: int,
             inspect_fn: Optional[Callable[[str], Any]] = None,
             block_while_paused: bool = True) -> Dict[str, Any]:
        """Drain mailbox; if paused, keep responding until resumed."""
        while True:
            try:
                while True:
                    msg = self.mailbox.get_nowait()
                    self._apply(msg, step, microbatch, inspect_fn)
            except queue.Empty:
                pass
            if self.paused and block_while_paused and not self.stopped:
                try:
                    msg = self.mailbox.get(timeout=0.05)
                    self._apply(msg, step, microbatch, inspect_fn)
                except queue.Empty:
                    continue
                continue
            break
        updates, self.config_updates = self.config_updates, {}
        plan, self.pending_plan = self.pending_plan, None
        return {"updates": updates, "plan": plan, "stopped": self.stopped}

    # --------------------------------------------------------------- replay
    def is_replaying(self) -> bool:
        """True while logged control messages are still pending re-application
        (recovery); the loop must stay on the granulated path so they land at
        their recorded (step, microbatch) points.  Covers both
        ReplayingController and replay_into-style injection."""
        return bool(getattr(self, "_replay", None))

    def replay_records(self, after_step: int) -> List[LogRecord]:
        """Records to re-apply when recovering from a checkpoint taken at the
        end of ``after_step`` (§2.6.2 recovery)."""
        return [r for r in self.log if r.step > after_step]


def replay_into(controller: "Controller", records: List[LogRecord]) -> None:
    """Pre-load a recovered controller so the loop re-applies messages at
    their original (step, microbatch) points."""
    controller._replay = sorted(records, key=lambda r: (r.step, r.microbatch,
                                                        r.seq))


class ReplayingController(Controller):
    """Controller that injects logged messages at their recorded points —
    used during recovery; new live messages are held until replay is done
    (paper: 'the coordinator holds new control messages ... until the worker
    has replayed all its control-replay log records')."""

    def __init__(self, records: List[LogRecord]):
        super().__init__()
        self._replay = sorted(records, key=lambda r: (r.step, r.microbatch,
                                                      r.seq))

    def poll(self, step: int, microbatch: int, inspect_fn=None,
             block_while_paused: bool = True):
        while self._replay and (self._replay[0].step, self._replay[0].microbatch) <= (step, microbatch):
            r = self._replay.pop(0)
            msg = ControlMessage(r.kind, r.payload)
            if r.kind == "pause":
                # replayed pause+resume pairs cancel; state effects
                # (update/plan) are what must be reproduced exactly
                continue
            if r.kind == "resume":
                continue
            self._apply(msg, step, microbatch, inspect_fn)
        if self._replay:
            # hold live messages until replay completes
            updates, self.config_updates = self.config_updates, {}
            plan, self.pending_plan = self.pending_plan, None
            return {"updates": updates, "plan": plan, "stopped": self.stopped}
        return super().poll(step, microbatch, inspect_fn, block_while_paused)
