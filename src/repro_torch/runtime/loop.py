"""Interactive training loop — an engine client on the ML runtime (the JAX
package's ``runtime/loop.py`` over torch state on one device).

The loop no longer owns the control plane: an :class:`repro_torch.engine.Engine`
holds the controller mailbox, the durable control-replay log, and the
registered breakpoints, and the loop submits its work as engine *jobs*
(train step on either path, checkpoint).  Which step path runs is the
engine's Maestro decision (``choose_step_path``): granulated whenever
interactivity is live — the Amber per-microbatch control points (§2.4.3/4)
— otherwise the cheaper path under the measured cost model (which subsumes
the old hard-coded ``auto`` heuristic).  Reshape (MoEReshaper) observes the
free load metrics and swaps the routing plan + migrates expert state
between steps.  Fault tolerance: checkpoints carry the data-iterator state
and the control-replay log; ``TrainLoop.recover`` restores and re-applies
logged messages at their recorded (step, microbatch) points -> bit-exact
continuation (§2.6.2).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import (Checkpointer, to_numpy_tree,
                                                 to_device_tree)
from repro_torch.configs.base import ArchConfig
from repro_torch.core.breakpoints import GlobalCountBreakpoint, LocalBreakpoint
from repro_torch.core.controller import Controller, ReplayingController
from repro_torch.core.reshape_moe import MoEReshaper
from repro_torch.data.synthetic import TokenStream
from repro_torch.engine.engine import Engine
from repro_torch.engine.jobs import Job, dispatch_kind
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime.train import (TrainHyper, build_fused_step,
                                       build_grad_step, make_state)


@dataclasses.dataclass
class LoopConfig:
    microbatches: int = 2
    ckpt_every: int = 0                  # 0 = off
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    # two-region checkpointing: the blocking device->host snapshot always
    # runs between steps; with ckpt_async the host->disk persist runs on the
    # Checkpointer worker thread, overlapped with the next step's regions
    # (False = legacy blocking save, the measured baseline)
    ckpt_async: bool = True
    # publish host-side params to `publish_to` every N steps (0 = off):
    # the train->serve weight-publishing hook (ROADMAP item 3)
    publish_every: int = 0
    lr_scale: float = 1.0
    # step-path selection: "auto" pays the granulated interactivity tax only
    # when interactivity is in use (pending message / breakpoint / pause /
    # replay); "granulated" and "fused" force one path (benchmarks).
    step_path: str = "auto"
    # MoE dispatch kernel selection: "off" keeps the cfg's fused_dispatch
    # setting; "auto" lets the engine pick fused-vs-argsort ("xla", the
    # reference's name for it) per shape from measured CostBook step times;
    # "fused"/"xla" force one.  Only meaningful for MoE configs.
    dispatch_select: str = "off"
    # the device the state lives on; the CPU is for tests
    device: str = "cuda"


class TrainLoop:
    def __init__(self, cfg: ArchConfig, stream: TokenStream,
                 hyper: TrainHyper = TrainHyper(),
                 loop_cfg: LoopConfig = LoopConfig(),
                 controller: Optional[Controller] = None,
                 reshaper: Optional[MoEReshaper] = None,
                 seed: int = 0, engine: Optional[Engine] = None,
                 publish_to: Any = None):
        self.cfg = cfg
        self.stream = stream
        self.hyper = hyper
        self.lc = loop_cfg
        assert loop_cfg.step_path in ("auto", "fused", "granulated"), \
            loop_cfg.step_path
        assert loop_cfg.dispatch_select in ("off", "auto", "fused", "xla"), \
            loop_cfg.dispatch_select
        assert engine is None or controller is None, \
            "pass either an engine or a bare controller, not both"
        self.engine = engine or Engine(controller=controller)
        self.reshaper = reshaper
        self.device = torch.device(loop_cfg.device)
        self.state = make_state(cfg, torch.Generator(
            device=self.device).manual_seed(seed), device=self.device)
        self.grad_mb, self.apply, self.migrate = build_grad_step(cfg, hyper)
        self.fused_step = build_fused_step(cfg, hyper)
        # per-dispatch-impl step fns, built lazily when the engine is
        # selecting the MoE dispatch kernel at runtime (dispatch_select);
        # _impl_warm tracks which (impl, path) pairs have already run once,
        # so their first step (kernel builds, GEMM heuristics, allocator
        # growth) is marked cold and never enters ANY cost EMA
        self._impl_fns: Dict[str, Any] = {}
        self._impl_warm: set = set()
        self._plan_dev = None            # cached device-resident plan arrays
        nl = lm.n_moe_layers(cfg)
        if nl:
            plan = moe_lib.identity_plan(cfg, nl, device="cpu")
            self._set_plan(np.asarray(plan.slots), np.asarray(plan.cum))
            if reshaper is not None:
                self._set_plan(reshaper.plan_slots.copy(),
                               reshaper.plan_cum.copy())
        else:
            self.plan_slots = self.plan_cum = None
        self.history: List[Dict[str, Any]] = []
        # weight-publish sink: a ServeEngine (its .update() mailbox) or a
        # bare Controller (.send); params go out as host-numpy trees
        self.publish_to = publish_to
        self._last_snapshot: Optional[Dict[str, Any]] = None
        self.ckpt = Checkpointer(self.lc.ckpt_dir) if self.lc.ckpt_every \
            else None
        if self.ckpt is not None and self.controller.durable_log_path is None:
            self.controller.attach_durable_log(
                os.path.join(self.lc.ckpt_dir, "control.log"))
        self.hit_breakpoints: List[str] = []

    # the control plane lives on the engine; these views keep the worker's
    # historical surface (tests, examples, benchmarks) intact
    @property
    def controller(self) -> Controller:
        return self.engine.controller

    @property
    def local_bps(self) -> List[LocalBreakpoint]:
        return self.engine.local_bps

    @property
    def global_bps(self) -> List[GlobalCountBreakpoint]:
        return self.engine.global_bps

    # ------------------------------------------------------------- plumbing
    def _inspect(self, what: str):
        step = int(self.state["step"])
        info = {"step": step, "stream": self.stream.state(),
                "paused": self.controller.paused,
                "history_tail": self.history[-3:]}
        if what == "plan" and self.plan_slots is not None:
            info["plan_slots"] = self.plan_slots.tolist()
        if what == "engine":
            info["engine"] = self.engine.inspect()
        return info

    def _apply_updates(self, updates: Dict[str, Any]) -> None:
        if "lr_scale" in updates:
            self.lc.lr_scale = float(updates["lr_scale"])
        if "tau" in updates and self.reshaper is not None:
            self.reshaper.params.tau = float(updates["tau"])

    def _poll(self, step: int, mb: int) -> bool:
        r = self.engine.poll(step, mb, self._inspect)
        self._apply_updates(r["updates"])
        if r["plan"] is not None:
            self._set_plan(np.asarray(r["plan"]["slots"]),
                           np.asarray(r["plan"]["cum"]))
            if r["plan"]["migrations"]:
                self._migrate(r["plan"]["migrations"])
        return r["stopped"]

    def _migrate(self, migrations) -> None:
        if not migrations:
            return
        arr = np.asarray([[m.layer, m.src_slot, m.dst_slot]
                          for m in migrations], np.int32)
        self.state = self.migrate(self.state, arr)

    def _set_plan(self, slots, cum) -> None:
        """Single mutation point for the routing plan.  The cached device
        arrays are invalidated only when the plan VALUES change — the reshaper
        returns fresh copies every step, which must not force an H2D
        re-upload per step (let alone the old one per microbatch)."""
        if (self._plan_dev is not None and self.plan_slots is not None
                and np.array_equal(slots, self.plan_slots)
                and np.array_equal(cum, self.plan_cum)):
            self.plan_slots, self.plan_cum = slots, cum
            return
        self.plan_slots, self.plan_cum = slots, cum
        self._plan_dev = None

    def _plan_args(self):
        if self._plan_dev is None:
            if self.plan_slots is None:
                self._plan_dev = (None, None)
            else:
                self._plan_dev = (
                    torch.as_tensor(np.asarray(self.plan_slots),
                                    dtype=torch.long, device=self.device),
                    torch.as_tensor(np.asarray(self.plan_cum),
                                    dtype=torch.float32, device=self.device))
        return self._plan_dev

    # ----------------------------------------------------------------- run
    def _dispatch_impl(self, n_tok: int):
        """Engine-chosen MoE dispatch kernel for this step (or None when
        selection is off / the model has no MoE).  Returns (impl,
        (grad_mb, fused_step)) — the step fns built for that impl."""
        if self.lc.dispatch_select == "off" or self.cfg.moe is None:
            return None, (self.grad_mb, self.fused_step)
        forced = ("auto" if self.lc.dispatch_select == "auto"
                  else self.lc.dispatch_select)
        impl = self.engine.choose_dispatch_impl(n_tok, forced=forced)
        if impl not in self._impl_fns:
            c = dataclasses.replace(
                self.cfg, moe=dataclasses.replace(
                    self.cfg.moe, fused_dispatch=(impl == "fused")))
            gm, _, _ = build_grad_step(c, self.hyper)
            self._impl_fns[impl] = (gm, build_fused_step(c, self.hyper))
        return impl, self._impl_fns[impl]

    def _fused_eligible(self) -> bool:
        """Step-path choice, delegated to the engine.  Whenever interactivity
        is actually in use (pending/replaying message, breakpoint, paused)
        the engine returns the granulated path so Amber's per-microbatch
        semantics are preserved exactly; otherwise it scores both step-job
        workflows under the measured cost model and picks the cheaper —
        the PR-1 ``auto`` heuristic, now as a Maestro decision."""
        return self.engine.choose_step_path(
            self.lc.step_path, self.lc.microbatches) == "fused"

    def _check_breakpoints(self, m_host: Dict[str, Any],
                           tokens_count: float) -> None:
        for bp in self.local_bps:
            if bp.check({k: v for k, v in m_host.items()
                         if np.ndim(v) == 0}):
                self.hit_breakpoints.append(bp.name)
                self.controller.paused = True
        for bp in list(self.global_bps):
            if bp.update([tokens_count]):
                self.hit_breakpoints.append(bp.name)
                self.controller.paused = True
                # COUNT targets fire once (unlike local condition
                # breakpoints, which re-check every iteration)
                self.global_bps.remove(bp)

    def _step_granulated(self, step: int, batch, n_mb: int, grad_mb=None):
        """One training step at microbatch control granularity (§2.4.3).
        Returns (step_metrics, stopped); metrics is None when stopped."""
        grad_mb = self.grad_mb if grad_mb is None else grad_mb
        gb = batch["tokens"].shape[0]
        mb_sz = gb // n_mb
        grads = None
        sums: Dict[str, Any] = {}
        mb_done = 0
        for i in range(n_mb):
            mbd = self._model_batch(
                batch["tokens"][i * mb_sz:(i + 1) * mb_sz])
            ps, pc = self._plan_args()
            offset = (step * n_mb + i) * mb_sz * self.stream.seq_len
            g, metrics = grad_mb(self.state["params"], mbd, ps, pc, offset)
            grads = g if grads is None else tree_map(
                lambda a, b: a.add_(b), grads, g)
            m_host = _to_host(metrics)
            sums = _merge_metrics(sums, m_host)
            mb_done += 1
            # --- Amber granulated control point (one per microbatch) ---
            self._check_breakpoints(m_host, float(mbd["tokens"].numel()))
            if self._poll(step, i + 1):
                return None, True
        step_metrics = _finalize_metrics(sums, mb_done)
        self.state, opt_m = self.apply(self.state, grads, n_mb,
                                       self.lc.lr_scale, donate=True)
        step_metrics.update(_to_host(opt_m))
        return step_metrics, False

    def _step_fused(self, step: int, batch, n_mb: int,
                    fused_step=None) -> Dict[str, Any]:
        """One training step through the fused step: all microbatches in one
        call, one device->host metrics fetch.  The state is handed over
        and updated in place."""
        fused_step = self.fused_step if fused_step is None else fused_step
        gb = batch["tokens"].shape[0]
        used = (gb // n_mb) * n_mb      # granulated path drops the remainder
        bd = self._model_batch(batch["tokens"][:used])
        ps, pc = self._plan_args()
        self.state, mb_metrics, opt_m = fused_step(
            self.state, bd, ps, pc, self.lc.lr_scale, n_mb=n_mb, step=step,
            donate=True)
        mb_host, opt_host = _to_host(mb_metrics), _to_host(opt_m)
        if self.local_bps or self.global_bps:
            # forced step_path="fused" with registered breakpoints (auto
            # mode never gets here): evaluate the predicates post hoc on
            # the stacked per-microbatch metrics
            tokens_mb = float(used * batch["tokens"].shape[1]) / n_mb
            for i in range(n_mb):
                self._check_breakpoints(
                    {k: np.asarray(v)[i] for k, v in mb_host.items()},
                    tokens_mb)
        step_metrics = {
            k: (np.asarray(v).mean(0) if k in _MEAN_KEYS
                else np.asarray(v).sum(0))
            for k, v in mb_host.items()}
        step_metrics.update({k: np.asarray(v) for k, v in opt_host.items()})
        return step_metrics

    def _model_batch(self, tokens: np.ndarray) -> Dict[str, torch.Tensor]:
        """The model's batch for ``tokens``; an encoder-decoder also gets
        zero frames [B, enc_seq, d_model] f32, as the reference's loop."""
        bd = {"tokens": self._tokens(tokens)}
        if self.cfg.enc_layers:
            bd["frames"] = torch.zeros(
                (tokens.shape[0], self.cfg.enc_seq, self.cfg.d_model),
                dtype=torch.float32, device=bd["tokens"].device)
        return bd

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(tokens),
                               device=self.device)

    def run(self, steps: int) -> List[Dict[str, Any]]:
        n_mb = self.lc.microbatches
        for _ in range(steps):
            step = int(self.state["step"])
            if self._poll(step, 0):
                break
            batch = self.stream.next()
            n_tok = int(batch["tokens"].size)
            impl, (grad_mb, fused_step) = self._dispatch_impl(n_tok)
            fused_path = self._fused_eligible()
            extra, meta = (), None
            if impl is not None:
                key = (impl, fused_path)
                meta = {"cold": key not in self._impl_warm}
                self._impl_warm.add(key)
                if fused_path:
                    # dispatch-impl samples come from fused-path steps only:
                    # mixing fused- and granulated-step durations under one
                    # dispatch_kind key would compare the impls across
                    # different step paths, not against each other
                    extra = (Job(dispatch_kind(impl, n_tok), tokens=n_tok,
                                 meta=meta),)
            if fused_path:
                step_metrics = self.engine.run_job(
                    Job("train_step_fused", tokens=n_tok, meta=meta),
                    lambda: self._step_fused(step, batch, n_mb, fused_step),
                    extra=extra)
            else:
                t0 = time.perf_counter()
                log_before = len(self.controller.log)
                step_metrics, stopped = self._step_granulated(
                    step, batch, n_mb, grad_mb)
                if stopped:
                    break
                if len(self.controller.log) == log_before:
                    # clean measurement only: a step that served control
                    # messages (or sat paused) must not poison the cost model
                    self.engine.observe(
                        Job("train_step_granulated", tokens=n_tok,
                            meta=meta), time.perf_counter() - t0)
            self.history.append({"step": step, **{
                k: (float(v) if np.ndim(v) == 0 else v)
                for k, v in step_metrics.items()}})
            # ---------------- Reshape between-steps fast control path ------
            if self.reshaper is not None and "expert_counts" in step_metrics:
                self.reshaper.observe(step_metrics["expert_counts"],
                                      step_metrics.get("dropped"))
                ps, pc, migs = self.reshaper.step()
                if migs:
                    self._migrate(migs)
                self._set_plan(ps, pc)
            if self.ckpt and (step + 1) % self.lc.ckpt_every == 0:
                self.save(step + 1)
            if self.publish_to is not None and self.lc.publish_every and \
                    (step + 1) % self.lc.publish_every == 0:
                self.publish(step + 1)
        if self.ckpt is not None:
            # completion barrier: every queued persist is durable (and any
            # worker-side error re-raised here) before run() returns
            self.ckpt.wait()
        return self.history

    # -------------------------------------------------------- fault tolerance
    def save(self, step: int) -> str:
        """Two-region checkpoint (engine.jobs.snapshot_workflow /
        persist_workflow): the blocking device->host snapshot runs inline as
        a measured ``ckpt_snapshot`` job, then the host->disk persist either
        queues on the Checkpointer worker (ckpt_async — its measured wall
        time feeds the ``ckpt_persist`` EMA from the completion callback, so
        the scheduler prices the overlapped region from observation) or runs
        inline as the blocking baseline.  Returns the checkpoint path the
        persist will (or did) publish."""
        extra = {"stream": self.stream.state(),
                 "plan_slots": None if self.plan_slots is None
                 else np.asarray(self.plan_slots),
                 "plan_cum": None if self.plan_cum is None
                 else np.asarray(self.plan_cum),
                 "lr_scale": self.lc.lr_scale}
        payload = self.engine.run_job(
            Job("ckpt_snapshot"),
            lambda: self.ckpt.snapshot(step, self.state,
                                       self.controller.log, extra))
        self._last_snapshot = payload
        if self.lc.ckpt_async:
            self.ckpt.persist_async(
                payload, on_done=lambda dt: self.engine.observe(
                    Job("ckpt_persist"), dt))
        else:
            self.engine.run_job(Job("ckpt_persist"),
                                lambda: self.ckpt.persist(payload))
        return self.ckpt._path(step)

    def publish(self, version: int) -> None:
        """Send the current host-side params to ``publish_to`` tagged with
        ``version`` (the train step).  Reuses the checkpoint snapshot's
        host copy when one was just taken at this step — publish and persist
        then share a single device sync.  The sink applies the swap at its
        own tick boundary (``ServeEngine.update`` mailbox semantics)."""
        snap = self._last_snapshot
        if snap is not None and snap["step"] == version:
            params = snap["state"]["params"]
        else:
            params = to_numpy_tree(self.state["params"])
        target = self.publish_to
        if hasattr(target, "update"):       # ServeEngine
            target.update(params=params, params_version=version)
        else:                               # bare Controller mailbox
            from repro_torch.core import messages as M
            target.send(M.update(params=params, params_version=version))

    @classmethod
    def recover(cls, cfg: ArchConfig, stream: TokenStream,
                hyper: TrainHyper, loop_cfg: LoopConfig,
                reshaper: Optional[MoEReshaper] = None) -> "TrainLoop":
        ckpt = Checkpointer(loop_cfg.ckpt_dir)
        payload = ckpt.restore()
        assert payload is not None, "no checkpoint to recover from"
        step = payload["step"]
        # the coordinator's durable log survives the crash (§2.6.2 A1) and
        # includes messages applied after the checkpoint was taken
        durable = Controller.read_durable_log(
            os.path.join(loop_cfg.ckpt_dir, "control.log"))
        records = durable or payload["control_log"]
        controller = ReplayingController(
            [r for r in records if r.step >= step])
        loop = cls(cfg, stream, hyper, loop_cfg, controller=controller,
                   reshaper=reshaper)
        loop.state = to_device_tree(payload["state"], loop.device)
        loop.stream.restore(payload["extra"]["stream"])
        loop.lc.lr_scale = payload["extra"]["lr_scale"]
        if payload["extra"]["plan_slots"] is not None:
            loop._set_plan(payload["extra"]["plan_slots"],
                           payload["extra"]["plan_cum"])
        # replayed messages were already logged pre-crash; keep the old log
        loop.controller.log = list(records)
        return loop


def _to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in metrics.items()}


# metric keys averaged over microbatches; everything else is summed
_MEAN_KEYS = ("ce", "loss", "aux_loss")


def _merge_metrics(acc: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """Accumulate per-microbatch metric SUMS (mean keys are divided once by
    the microbatch count in ``_finalize_metrics`` — a running (a+b)/2 average
    would exponentially down-weight early microbatches when n_mb > 2)."""
    out = dict(acc)
    for k, v in new.items():
        out[k] = v if k not in out else out[k] + v
    return out


def _finalize_metrics(sums: Dict[str, Any], n_mb: int) -> Dict[str, Any]:
    out = dict(sums)
    for k in _MEAN_KEYS:
        if k in out:
            out[k] = out[k] / max(n_mb, 1)
    return out
