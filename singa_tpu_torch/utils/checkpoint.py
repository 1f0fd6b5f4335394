"""Trainer-level checkpoint and resume (counterpart of
singa_tpu/utils/checkpoint.py): the wiring the example trainers share,
routed onto the `singa_tpu_torch.resilience` commit protocol.

- `save_checkpoint(model, optimizer, path, step)` writes `path` as a
  resilience checkpoint DIRECTORY (shard files, MANIFEST.json, LATEST,
  each written atomically) recording `step + 1` as the resume point, and
  keeps the newest two. The optimizer's per-rank states (ZeRO-1 shards,
  error-feedback residuals) are stored in CANONICAL, world-independent
  form (`DistOpt.canonicalize_states`, marked ``opt_canonical`` in the
  manifest's meta), so the checkpoint resumes at any world size. In a
  group of several ranks every rank calls it: the canonical form is a
  collective, and the save is the two-phase commit in which each rank
  writes the shards it owns.
- `maybe_resume(model, optimizer, path)` resumes when `path` exists and
  returns the step to continue from (0 when starting fresh): a
  checkpoint directory through `resilience.restore` (canonical states
  resharded to THIS world by `DistOpt.reshard_states` in its
  `opt_transform` hook), or a legacy single-file zip written by
  `Model.save_states` (either package's), with its old semantics.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

__all__ = ["maybe_resume", "save_checkpoint"]


def maybe_resume(model, optimizer, path: Optional[str]) -> int:
    """Resume `model` (and `optimizer`'s slots) from `path` if it
    exists; returns the step to continue from (0 when starting fresh).
    Call after `model.compile`, so the parameters exist.

    `path` is a resilience checkpoint directory (what `save_checkpoint`
    writes: integrity-verified, read into the current layout, canonical
    per-rank states resharded to this world) or a legacy single-file zip
    (canonical-marked states reshard; raw per-rank states of another
    world are refused)."""
    if not path:
        return 0
    from singa_tpu_torch import storage

    drv = storage.get_driver(path)
    if drv.isdir(path):
        start = _resume_manifest(model, optimizer, path)
    elif os.path.isfile(path):
        # a plain FILE at the path is a legacy zip: a posix format by
        # construction, so a stray object at a schemed key is not fed
        # to the zip reader
        start = _resume_legacy_zip(model, optimizer, path)
    else:
        return 0
    print(f"resumed from {path} at step {start}")
    return start


def _resume_manifest(model, optimizer, path: str) -> int:
    """Resume from a resilience checkpoint: `restore` does the
    integrity, coverage and placement work; this decides how the
    optimizer's states load (canonical reshard or raw) and keeps the
    lenient surface (a model-only checkpoint or optimizer=None warm
    start)."""
    from singa_tpu_torch import resilience
    from singa_tpu_torch.resilience import checkpoint as rckpt

    manifest, _ = rckpt.read_manifest(path)
    has_opt = any(leaf["name"].startswith("opt/")
                  for leaf in manifest["leaves"])
    canonical = bool((manifest.get("meta") or {}).get("opt_canonical"))
    if optimizer is None or not has_opt:
        meta = resilience.restore(path, model, None,
                                  allow_partial=has_opt)
        return int(meta["step"])
    transform = None
    if canonical and hasattr(optimizer, "reshard_states"):
        transform = optimizer.reshard_states
    meta = resilience.restore(path, model, optimizer,
                              opt_transform=transform)
    return int(meta["step"])


def _resume_legacy_zip(model, optimizer, path: str) -> int:
    """The single-file zip reader (`Model.save_states`' archive with the
    optimizer's states under ``opt//`` in its aux entries), kept so old
    checkpoints stay resumable; nothing writes this form any more."""
    aux = model.load_states(path)
    opt_states = {
        k[len("opt//"):]: v for k, v in aux.items()
        if k.startswith("opt//")
    }
    if opt_states and optimizer is not None:
        optimizer.prepare(model.get_params())
        canonical = bool(np.asarray(aux.get("opt_canonical", 0)))
        if canonical and hasattr(optimizer, "reshard_states"):
            opt_states = optimizer.reshard_states(opt_states)
        else:
            _check_legacy_world(optimizer, opt_states, path)
        optimizer.load_states(
            {k: torch.as_tensor(np.asarray(v)) for k, v in
             opt_states.items()})
    return int(aux.get("step", 0))


def _check_legacy_world(optimizer, opt_states, path) -> None:
    """A legacy (raw per-rank) checkpoint must match this run's world:
    refused loudly, never loaded mis-shaped."""
    from singa_tpu_torch.communicator import is_per_chip_state_key

    world = getattr(getattr(optimizer, "comm", None), "world_size", 1)
    if max(1, world) == 1:
        # world-1 states are plain-shaped: shape[0] is not a world
        return
    for k, v in opt_states.items():
        if is_per_chip_state_key(k) and np.asarray(v).ndim >= 1 \
                and np.asarray(v).shape[0] != max(1, world):
            raise ValueError(
                f"checkpoint {path!r} holds raw per-chip state {k!r} "
                f"for world size {np.asarray(v).shape[0]}, but this "
                f"run's world size is {world}; re-save with the "
                f"current framework (canonical form) or resume on the "
                f"original chip count")


def save_checkpoint(model, optimizer, path: str, step: int) -> None:
    """Write parameters, buffers and optimizer states to the checkpoint
    directory `path` through the resilience commit protocol, recording
    `step + 1` as the resume point, then keep the newest two.

    The optimizer's states are stored in canonical, world-independent
    form when it has one (`DistOpt.canonicalize_states`). In a group of
    several ranks EVERY rank calls this: the canonical form gathers the
    per-rank rows (a collective), each rank writes the shards it owns,
    and rank 0 commits and prunes."""
    from singa_tpu_torch import distributed, resilience

    multiproc = distributed.process_count() > 1
    rank0 = distributed.process_index() == 0
    if os.path.isfile(path):
        # a LEGACY zip sits where the directory goes: moved aside (still
        # readable at .legacy), never destroyed
        if rank0:
            os.replace(path, path + ".legacy")
    if multiproc and not rank0:
        import time

        t0 = time.monotonic()
        while os.path.isfile(path) and time.monotonic() - t0 < 60.0:
            time.sleep(0.05)
        if os.path.isfile(path):
            raise resilience.CheckpointError(
                f"save_checkpoint: a legacy single-file checkpoint "
                f"still sits at {path!r} after 60s: rank 0 never moved "
                f"it aside; refusing to join the save against a file "
                f"path")
    opt_states = meta = None
    if optimizer is not None and hasattr(optimizer,
                                         "canonicalize_states"):
        opt_states = optimizer.canonicalize_states(
            optimizer.dump_states())
        meta = {"opt_canonical": True}
    resilience.save(path, model, optimizer, step=int(step) + 1,
                    opt_states=opt_states, meta=meta)
    if rank0:
        resilience.prune(path, keep=2)
