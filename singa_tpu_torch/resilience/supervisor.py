"""The self-healing training supervisor: crash and hang restarts and
loss-spike rollback around the checkpoint (counterpart of
singa_tpu/resilience/supervisor.py).

- **Crash and hang restarts.** The train loop runs under the supervisor;
  any crash, a `watchdog.StepHangError` from a step that blew its
  deadline among them, triggers a rebuild (`build_fn`: a fresh model and
  optimizer) and a restore from the latest committed checkpoint, paced
  by the bounded exponential backoff shared with `resilience.retry`
  (`exp_backoff_s`). Deterministic Python error classes and a
  `CheckpointError` fail fast: a shape bug restarts into the same bug.
  The restart budget is the run's total, so a persistent fault
  exhausts it and re-raises, with `restart_history` attached.
- **Loss-spike rollback.** An `anomaly.SpikeDetector` reads the loss the
  step returns. On a spike the supervisor restores the last good
  checkpoint and advances the data cursor past the poison window (the
  batches from the restored step to the poisoned one are skipped), and
  commits the advanced cursor at once. Checkpoints are committed only
  for steps the detector passed, so "last committed" is "last good".
- **Mesh choice.** With ``mesh_fn`` the supervisor probes the live
  process group on every (re)build: ``mesh_fn(ranks)`` (one device per
  rank) returns (dp, tp, sp), the supervisor builds the mesh with
  `parallel.mesh.get_mesh_3d(..., devices=)` and calls
  ``build_fn(mesh=...)``; a rebuild whose extents moved bumps
  ``reshapes``, and the elastic restore re-places the checkpoint onto
  the new mesh. `default_mesh_fn(dp, tp, sp)` keeps tp and folds lost
  devices out of dp, then sp. One difference from the reference: its
  probe can see fewer chips inside one process and shrink onto them; a
  torch process group has a fixed world, and a rank left out of a
  smaller mesh would still have to join every save and restore, so a
  mesh over fewer ranks than the group raises `NotImplementedError`
  here (a deterministic class: no restart is spent on it). The port
  shrinks across processes instead: a fleet epoch (`resilience.fleet`)
  respawns the trainers at a smaller ``SINGA_FLEET_WORLD``, they form a
  smaller group, and this probe folds dp onto it.
- **Rebuilds on the card.** A captured step owns a CUDA Graph and its
  private memory pool. The supervisor drops every reference it holds to
  the failed model (the model, the exception and its traceback's frames)
  and collects cycles before `build_fn` runs again, so a restart does
  not keep the previous model's memory. A sticky CUDA error (an illegal
  address, a device-side assert) makes every in-process rebuild fail
  again; the budget then re-raises with `restart_history`. That is the
  babysitter's jurisdiction, across processes.
- **Observability.** Every restart, rollback, hang and reshape bumps the
  process-wide ``counters``, which `Model.fault_counters` merges; the
  heal is traced: ``supervisor.restart`` covers backoff, rebuild and
  restore (the ``checkpoint.read`` nests under it), and
  ``supervisor.rollback`` parents ``anomaly.spike``,
  ``checkpoint.read`` and ``checkpoint.write``.

The per-step contract: `build_fn()` returns a compiled model whose
``train_one_batch(*batch)`` returns ``(out, loss)`` and whose optimizer
is set. `batches` is an indexable sequence or a ``fn(cursor) -> batch``
callable. `fault_hook(step, batch)` is the injection point
(`faults.crash_at`, `stall_at`, `poison_batch_at`); it runs inside the
watchdog's window and may raise, stall or return a replacement batch.
The supervisor reads ``float(loss)`` every step, as the reference does:
one host sync a step. It reads it inside the watchdog's window (the
reference reads it after): a step's launches return before the card has
run them, so only the read makes the deadline cover the step's device
time.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, Optional

from singa_tpu_torch.observability import trace
from singa_tpu_torch.resilience import checkpoint as ckpt
from singa_tpu_torch.resilience import counters, retry
from singa_tpu_torch.resilience.watchdog import StepHangError, Watchdog

__all__ = ["Supervisor", "choose_mesh", "default_mesh_fn", "probe_ranks"]


def _largest_divisor_leq(n: int, cap: int) -> int:
    """The largest divisor of `n` that is <= cap (>= 1)."""
    for d in range(min(int(n), int(cap)), 0, -1):
        if n % d == 0:
            return d
    return 1


def choose_mesh(n_devices: int, dp: int, tp: int = 1, sp: int = 1):
    """The default mesh policy as a pure function: fit the launch extents
    (dp, tp, sp) onto `n_devices` surviving devices.

    tp is kept (the column/row shard layout is a property of the
    weights); lost devices fold out of dp first and sp second, each to
    the largest divisor of its launch value that fits, so batch and
    sequence shards stay even. Growth is capped at the launch extents.
    Fewer devices than tp alone is refused; a custom ``mesh_fn`` may fold
    tp."""
    n = int(n_devices)
    dp, tp, sp = int(dp), int(tp), int(sp)
    if min(n, dp, tp, sp) < 1:
        raise ValueError(
            f"choose_mesh: extents must be positive, got "
            f"n_devices={n}, dp={dp}, tp={tp}, sp={sp}")
    if n < tp:
        raise RuntimeError(
            f"choose_mesh: {n} surviving device(s) cannot carry "
            f"tp={tp} — the default policy keeps tp for weight-shard "
            f"compatibility; pass a custom mesh_fn to fold tp too")
    dp = _largest_divisor_leq(dp, max(1, n // (tp * sp)))
    if dp * tp * sp > n:  # dp=1 still too big: fold sp next
        sp = _largest_divisor_leq(sp, max(1, n // (tp * dp)))
    return dp, tp, sp


def default_mesh_fn(dp: int, tp: int = 1, sp: int = 1):
    """The stock ``Supervisor(mesh_fn=)`` probe for the launch extents:
    every rebuild fits them onto the probed devices with `choose_mesh`."""

    def mesh_fn(devices):
        return choose_mesh(len(devices), dp, tp, sp)

    return mesh_fn


def probe_ranks() -> List[int]:
    """The devices of the live process group, one per rank: its ranks
    ([0] without a group). The port's counterpart of the reference's
    `jax.devices()` probe."""
    from singa_tpu_torch import distributed

    return list(range(int(distributed.process_count())))


def _drop_frames(exc: Optional[BaseException], seen=None) -> None:
    """Clear the tracebacks of `exc` and of every exception chained to
    it (`__cause__`, `__context__`): their frames hold the failed step's
    locals, the model among them."""
    seen = set() if seen is None else seen
    if exc is None or id(exc) in seen:
        return
    seen.add(id(exc))
    exc.__traceback__ = None
    _drop_frames(exc.__cause__, seen)
    _drop_frames(exc.__context__, seen)


class Supervisor:
    """Self-healing wrapper around a training loop (module docstring)::

        sup = Supervisor(build_fn, ckpt_dir,
                         step_timeout_s=600,
                         spike_detector=anomaly.SpikeDetector())
        result = sup.run(batches)        # heals itself to completion

    `result` is a dict: {"model", "steps", "cursor", "losses",
    "restarts", "rollbacks", "hangs", "reshapes", "mesh_extents",
    "skipped"}: `skipped` lists the [first, last] batch-index windows
    rollbacks jumped over; `losses` holds one float per retained step in
    final-trajectory order (rolled-back and crash-lost steps' losses are
    dropped)."""

    def __init__(self, build_fn: Callable[..., Any], ckpt_dir: str, *,
                 max_restarts: int = retry.RETRY_ATTEMPTS,
                 restart_backoff_s: float = retry.RETRY_BACKOFF_S,
                 backoff_factor: float = 2.0,
                 backoff_cap_s: float = 120.0,
                 step_timeout_s: Optional[float] = None,
                 spike_detector=None,
                 checkpoint_every: int = 1,
                 keep_checkpoints: int = 2,
                 fault_hook: Optional[Callable] = None,
                 mesh_fn: Optional[Callable] = None,
                 async_save: bool = False,
                 sleep=time.sleep):
        self.build_fn = build_fn
        #: device probe, consulted on every (re)build:
        #: mesh_fn(probe_ranks()) -> (dp, tp, sp); None: build_fn() pins
        #: its own mesh
        self.mesh_fn = mesh_fn
        self.ckpt_dir = str(ckpt_dir)
        self.max_restarts = int(max_restarts)
        self.restart_backoff_s = float(restart_backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.backoff_cap_s = float(backoff_cap_s)
        self.watchdog = (Watchdog(step_timeout_s)
                         if step_timeout_s else None)
        self.spike = spike_detector
        self.checkpoint_every = max(1, int(checkpoint_every))
        #: committed step dirs kept on disk (`checkpoint.prune` after
        #: every save)
        self.keep_checkpoints = max(1, int(keep_checkpoints))
        self.fault_hook = fault_hook
        #: saves snapshot on the step path and commit on a background
        #: thread; restores and rollbacks drain the pending commit first,
        #: and run() surfaces the final save's failure
        self.async_save = bool(async_save)
        self._last_save = None
        self._sleep = sleep  # injectable: tests must not really wait
        # this run's tallies (the counters registry is process-wide)
        self.restarts = 0
        self.rollbacks = 0
        self.hangs = 0
        self.reshapes = 0
        self.mesh_extents = None  # (dp, tp, sp) of the current build
        self.skipped: List[List[int]] = []
        self.losses: List[float] = []
        #: one record per absorbed restart, attached to the exception a
        #: budget exhaustion re-raises
        self.restart_history: List[Dict[str, Any]] = []

    # -- lifecycle -----------------------------------------------------------
    def _build(self):
        """One (re)build; with a mesh_fn, probe the group's ranks, pick
        the extents, build the mesh and hand it to build_fn(mesh=...),
        counting a reshape when the extents moved."""
        if self.mesh_fn is None:
            return self.build_fn()
        from singa_tpu_torch.parallel import mesh as mesh_module

        devices = probe_ranks()
        dp, tp, sp = (int(e) for e in self.mesh_fn(devices))
        if dp * tp * sp > len(devices):
            raise RuntimeError(
                f"mesh_fn chose (dp={dp}, tp={tp}, sp={sp}) = "
                f"{dp * tp * sp} devices but the probe found only "
                f"{len(devices)}")
        if dp * tp * sp < len(devices):
            raise NotImplementedError(
                f"mesh_fn chose (dp={dp}, tp={tp}, sp={sp}) = "
                f"{dp * tp * sp} of the group's {len(devices)} ranks: "
                f"the port does not shrink a process group in place "
                f"(a rank outside the mesh would still join every save "
                f"and restore); a shrink re-forms the group across "
                f"processes: a fleet epoch (resilience.fleet) respawns "
                f"the trainers at a smaller SINGA_FLEET_WORLD and they "
                f"form a smaller group")
        if self.mesh_extents is not None and \
                (dp, tp, sp) != self.mesh_extents:
            counters.bump("reshapes")
            self.reshapes += 1
            print(f"# supervisor: fleet probe picked mesh "
                  f"(dp={dp}, tp={tp}, sp={sp}) — was "
                  f"(dp={self.mesh_extents[0]}, "
                  f"tp={self.mesh_extents[1]}, "
                  f"sp={self.mesh_extents[2]}); the elastic restore "
                  f"re-places the checkpoint onto the new mesh")
        self.mesh_extents = (dp, tp, sp)
        mesh = mesh_module.get_mesh_3d(dp, tp, sp, devices=devices)
        return self.build_fn(mesh=mesh)

    def _save(self, model, opt_, step: int, cursor: int) -> None:
        if self.async_save:
            # the snapshot on the step path; the commit in the
            # background (prune skips the in-flight step dir)
            self._last_save = ckpt.save(self.ckpt_dir, model, opt_,
                                        step=step, data_cursor=cursor,
                                        async_=True)
        else:
            ckpt.save(self.ckpt_dir, model, opt_, step=step,
                      data_cursor=cursor)
        ckpt.prune(self.ckpt_dir, keep=self.keep_checkpoints)

    def _restore_or_init(self, model):
        """Latest committed checkpoint -> (trained, cursor); with none in
        the directory, commit the fresh state at step 0, so every later
        crash or rollback has a base. A checkpoint that exists but does
        not load (another model, corruption) propagates."""
        opt_ = model.optimizer
        # an in-flight background commit lands before "latest" is judged
        ckpt.wait_pending(self.ckpt_dir)
        try:
            ckpt.latest_step_dir(self.ckpt_dir)
        except ckpt.CheckpointError:
            # the slots exist in the step-0 base, so a crash at the first
            # step restores from it
            opt_.prepare(dict(model.named_parameters()))
            self._save(model, opt_, step=0, cursor=0)
            return 0, 0
        meta = ckpt.restore(self.ckpt_dir, model, opt_)
        cursor = meta["data_cursor"]
        trained = int(meta["step"])
        # steps after this checkpoint were lost with the crash
        del self.losses[trained:]
        return trained, int(trained if cursor is None else cursor)

    def run(self, batches, n_steps: Optional[int] = None
            ) -> Dict[str, Any]:
        """Drive the run to completion, healing crashes, hangs and spikes
        on the way; raises only when the restart budget is exhausted or
        the failure is deterministic (module docstring)."""
        if n_steps is None:
            n_steps = len(batches)
        get = batches if callable(batches) else batches.__getitem__
        model = None
        trained = cursor = 0
        # the heal span a restart opens: it covers backoff, rebuild and
        # restore, so the checkpoint.read nests under it
        heal = None
        while True:
            try:
                if model is None:
                    try:
                        model = self._build()
                        trained, cursor = self._restore_or_init(model)
                    finally:
                        if heal is not None:
                            heal.end(restored_step=trained)
                            heal = None
                trained, cursor = self._drive(model, get, int(n_steps),
                                              trained, cursor)
                if self._last_save is not None:
                    # the final background commit must be durable before
                    # the resume point is reported
                    self._last_save.result()
                    self._last_save = None
                break
            except retry.DETERMINISTIC_ERRORS:
                raise  # identical on every attempt
            except ckpt.CheckpointError:
                raise  # structural or corrupt: a restart reproduces it
            except SystemExit:
                raise
            except (Exception, KeyboardInterrupt) as exc:
                e: BaseException = exc
                if isinstance(e, KeyboardInterrupt):
                    # a watchdog expiry racing the step's completion lands
                    # its interrupt after the guard exited: the unconsumed
                    # record says so; a user's Ctrl-C has none
                    fired = (self.watchdog.pop_fired()
                             if self.watchdog is not None else None)
                    if fired is None:
                        raise
                    e = StepHangError(fired[0], fired[1],
                                      self.watchdog.timeout_s)
                if isinstance(e, StepHangError):
                    self.hangs += 1  # the watchdog bumped the counter
                if self.restarts >= self.max_restarts:
                    e.restart_history = list(self.restart_history)
                    raise e
                delay = retry.exp_backoff_s(
                    self.restarts, self.restart_backoff_s,
                    self.backoff_factor, self.backoff_cap_s)
                counters.bump("restarts")
                self.restarts += 1
                heal = trace.begin_span(
                    "supervisor.restart", cause=type(e).__name__,
                    step=trained, restart=self.restarts,
                    backoff_s=delay)
                self.restart_history.append(
                    {"restart": self.restarts,
                     "error": f"{type(e).__name__}: {e}",
                     "step": trained, "cursor": cursor,
                     "backoff_s": delay})
                print(f"# supervisor: {type(e).__name__}: {e} — restart "
                      f"{self.restarts}/{self.max_restarts} in "
                      f"{delay:.1f}s (restoring the latest committed "
                      f"checkpoint)")
                # nothing may keep the failed model alive into the
                # rebuild: the tracebacks' frames hold it
                _drop_frames(e)
                _drop_frames(exc)
                del e, exc
                model = None
                self._sleep(delay)
                gc.collect()
        return {"model": model, "steps": trained, "cursor": cursor,
                "losses": list(self.losses), "restarts": self.restarts,
                "rollbacks": self.rollbacks, "hangs": self.hangs,
                "reshapes": self.reshapes,
                "mesh_extents": self.mesh_extents,
                "skipped": [list(w) for w in self.skipped]}

    # -- the supervised inner loop -------------------------------------------
    def _one_step(self, model, step: int, batch):
        if self.fault_hook is not None:
            replaced = self.fault_hook(step, batch)
            if replaced is not None:
                batch = replaced
        _, loss = model.train_one_batch(*batch)
        return loss

    def _drive(self, model, get, n_steps: int, trained: int,
               cursor: int):
        opt_ = model.optimizer
        while cursor < n_steps:
            step = cursor
            batch = get(step)
            if self.watchdog is not None:
                with self.watchdog.guard(step):
                    lv = float(self._one_step(model, step, batch))
            else:
                lv = float(self._one_step(model, step, batch))
            if self.spike is not None and self.spike.update(lv):
                # roll back to the last good checkpoint and advance the
                # cursor past the poison window: one span, the detection
                # event and the restore and re-commit nested under it
                with trace.span("supervisor.rollback",
                                cause="loss_spike", step=step,
                                loss=lv):
                    trace.event("anomaly.spike", step=step, loss=lv)
                    ckpt.wait_pending(self.ckpt_dir)
                    meta = ckpt.restore(self.ckpt_dir, model, opt_)
                    counters.bump("rollbacks")
                    self.rollbacks += 1
                    window = [int(meta["data_cursor"] or meta["step"]),
                              step]
                    self.skipped.append(window)
                    trained = int(meta["step"])
                    cursor = step + 1
                    # the advanced cursor is committed at once (a
                    # same-step re-save gets a fresh dir): a crash here
                    # must not resume at the old cursor and re-feed the
                    # poisoned batch
                    del self.losses[trained:]
                    self._save(model, opt_, step=trained,
                               cursor=cursor)
                print(f"# supervisor: loss spike at step {step} "
                      f"(loss={lv:.3g}) — rolled back to step "
                      f"{trained}, skipping batches "
                      f"[{window[0]}, {window[1]}]")
                continue
            self.losses.append(lv)
            trained += 1
            cursor += 1
            if cursor >= n_steps or trained % self.checkpoint_every == 0:
                # committed after the detector passed the step: "last
                # committed" is "last good"
                self._save(model, opt_, step=trained, cursor=cursor)
        return trained, cursor
