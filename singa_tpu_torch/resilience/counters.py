"""Process-level fault observability counters (counterpart of
singa_tpu/resilience/counters.py, copied whole with the port's imports).

A tiny registry the resilience subsystem bumps whenever a fault was
absorbed instead of surfacing: `retry.retry_transient` counts retried
transients, `checkpoint.restore` counts restores, the supervisor layer
counts restarts/rollbacks and the watchdog counts hangs. `bench.py`
stamps a snapshot next to every result row and
`GraphStep.fault_counters` / `Model.fault_counters` surface the
supervisor share, so a metric measured across a restore, a retried
transient, or a self-healed restart is attributable, not silently
laundered.

Round 17: the int registry that used to live here is SUBSUMED by the
typed metric registry (`singa_tpu_torch.observability.metrics`) — every
counter below is now a registered `metrics.Counter` with a help string
(the metric-name lint enforces the declaration), visible to the
Prometheus/JSON exporters next to the gauges and histograms the
serving and training hot paths record. This module stays the fault-
counter FAÇADE: `bump`/`snapshot`/`reset`/`absorb_*`/`SUPERVISOR_KEYS`
keep working verbatim for every existing caller, and `snapshot()`
still reports only counters that were actually touched (missing == 0
to readers, so test deltas and the bench "faults" stamp are
byte-identical in shape to round 16).

Stdlib-only, as is observability.metrics.
"""

from __future__ import annotations

import os
from typing import Dict

from singa_tpu_torch.observability import metrics as _metrics

__all__ = ["bump", "snapshot", "reset", "SUPERVISOR_KEYS",
           "supervisor_snapshot", "BABYSIT_ENV", "RESTARTS_ENV",
           "absorb_babysitter_env", "FLEET_ENV", "FLEET_EPOCH_ENV",
           "FLEET_ELECTIONS_ENV", "absorb_fleet_env"]

#: the self-healing layer's counters (rounds 11-12): supervised
#: restarts after a crash/hang, spike rollbacks, watchdog-detected
#: hangs, supervisor mesh reshapes, plus the OUT-OF-PROCESS share — a
#: trainer running under the resilience babysitter inherits how often
#: it was hard-killed and respawned (restarts_external) and that it is
#: babysat at all (babysit), so Model.fault_counters and every bench
#: row stamp the external heals next to the in-process ones. Round 14
#: adds the FLEET share: a trainer spawned by a babysitter-fleet agent
#: inherits that it runs under a fleet (fleet), the job-level restart
#: epoch it is at (fleet_epochs — every bump respawned ALL hosts), and
#: how many lease elections the fleet has held (elections — >1 means a
#: leader failover happened). Round 15 adds the SERVING share:
#: preempt_drains counts SIGTERM drains the serving frontend absorbed
#: (in-flight requests decoded to completion instead of dropped).
#: Round 16 adds the SPECULATIVE share: spec_accepts/spec_rejects
#: count draft proposals the serving verify step accepted/rejected —
#: a collapsed acceptance rate (rejects >> accepts, the spec_storm
#: scenario) is a performance fault worth stamping next to a bench
#: number even though correctness never depends on it.
SUPERVISOR_KEYS = ("restarts", "rollbacks", "hangs", "reshapes",
                   "babysit", "restarts_external", "fleet",
                   "fleet_epochs", "elections", "preempt_drains",
                   "spec_accepts", "spec_rejects")

#: env vars the babysitter sets on every (re)spawn; the trainer-side
#: registry absorbs them at import so the external restart count is
#: visible from inside the healed process (babysitter.py is the writer)
BABYSIT_ENV = "SINGA_BABYSIT"
RESTARTS_ENV = "SINGA_BABYSIT_RESTARTS"

#: env vars a babysitter-fleet agent sets on every (re)spawn — the
#: SINGA_BABYSIT_RESTARTS pattern for the job-level restart protocol
#: (resilience/fleet.py is the writer; WORLD/RANK/HOST topology env
#: lives there, only the counter-absorbed trio is named here)
FLEET_ENV = "SINGA_FLEET"
FLEET_EPOCH_ENV = "SINGA_FLEET_EPOCH"
FLEET_ELECTIONS_ENV = "SINGA_FLEET_ELECTIONS"

def bump(name: str, n: int = 1) -> int:
    """Increment counter `name` by `n`; returns the new value."""
    return _metrics.counter(name).inc(int(n))


def snapshot() -> Dict[str, int]:
    """A copy of every touched counter (missing == 0 to readers)."""
    return _metrics.snapshot()


def reset() -> None:
    """Zero every metric in the process registry (test isolation).
    Widened in round 17 from counters to the whole registry — gauges
    and histograms isolate between tests the same way."""
    _metrics.reset()


def supervisor_snapshot() -> Dict[str, int]:
    """The self-healing keys as a dense dict (missing == 0): what the
    fault_counters surfaces and bench rows merge in."""
    snap = snapshot()
    return {k: snap.get(k, 0) for k in SUPERVISOR_KEYS}


def absorb_babysitter_env() -> None:
    """Seed the out-of-process counters from the babysitter's env vars
    (idempotent: SET, not bumped — re-imports must not double-count).
    A trainer spawned by ``python -m singa_tpu_torch.resilience.babysit``
    carries ``SINGA_BABYSIT=1`` and ``SINGA_BABYSIT_RESTARTS=<n>``; a
    run that was never babysat keeps both counters absent (== 0)."""
    if os.environ.get(BABYSIT_ENV):
        _metrics.counter("babysit").set_(1)
        try:
            got = int(os.environ.get(RESTARTS_ENV, "0"))
        except ValueError:
            got = 0
        _metrics.counter("restarts_external").set_(got)


def absorb_fleet_env() -> None:
    """Seed the fleet counters from the agent's env vars (idempotent:
    SET, not bumped — the absorb_babysitter_env contract). A trainer
    spawned by a `resilience.fleet.FleetAgent` carries
    ``SINGA_FLEET=1``, ``SINGA_FLEET_EPOCH=<n>`` and
    ``SINGA_FLEET_ELECTIONS=<k>``; a run outside a fleet keeps all
    three counters absent (== 0)."""
    if not os.environ.get(FLEET_ENV):
        return
    _metrics.counter("fleet").set_(1)
    for key, env in (("fleet_epochs", FLEET_EPOCH_ENV),
                     ("elections", FLEET_ELECTIONS_ENV)):
        try:
            got = int(os.environ.get(env, "0"))
        except ValueError:
            got = 0
        _metrics.counter(key).set_(got)


absorb_babysitter_env()
absorb_fleet_env()
