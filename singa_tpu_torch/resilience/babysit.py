"""CLI entry for the out-of-process babysitter (counterpart of
singa_tpu/resilience/babysit.py)::

    python -m singa_tpu_torch.resilience.babysit [--stale-after S]
        [--max-restarts N] [--heartbeat PATH] [--metrics-port PORT]
        -- <trainer cmd...>

Spawns the trainer command as a watched subprocess and heals hard hangs
(a stale heartbeat: SIGKILL the process tree, respawn with bounded
exponential backoff) and crashes (a nonzero exit: respawn). The
machinery, and what it can heal that the in-process watchdog and
supervisor cannot, is `singa_tpu_torch.resilience.babysitter`. Fleet
mode (``--fleet``) is not ported yet (ROADMAP queue 1 item 17) and
raises.
"""

from __future__ import annotations

import sys

from singa_tpu_torch.resilience.babysitter import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
