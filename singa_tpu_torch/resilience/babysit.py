"""CLI entry for the out-of-process babysitter (counterpart of
singa_tpu/resilience/babysit.py)::

    python -m singa_tpu_torch.resilience.babysit [--stale-after S]
        [--max-restarts N] [--heartbeat PATH] [--metrics-port PORT]
        -- <trainer cmd...>
    python -m singa_tpu_torch.resilience.babysit --fleet DIR
        --fleet-rank I --fleet-world N [fleet options] -- <trainer cmd...>

Spawns the trainer command as a watched subprocess and heals hard hangs
(a stale heartbeat: SIGKILL the process tree, respawn with bounded
exponential backoff) and crashes (a nonzero exit: respawn). The
machinery, and what it can heal that the in-process watchdog and
supervisor cannot, is `singa_tpu_torch.resilience.babysitter`. With
``--fleet`` the process is one host's agent of a babysitter fleet
(`singa_tpu_torch.resilience.fleet`): job-level epoch-bump restarts
decided by a lease-elected leader over a shared rendezvous directory.
"""

from __future__ import annotations

import sys

from singa_tpu_torch.resilience.babysitter import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
