"""The babysitter heartbeat (counterpart of the heartbeat half of
singa_tpu/resilience/watchdog.py). The step-deadline `Watchdog` thread
is ROADMAP queue 1 item 17."""

from __future__ import annotations

import os

__all__ = ["HEARTBEAT_ENV", "touch_heartbeat"]

#: env var naming the heartbeat file (a babysitter sets it on every
#: spawn)
HEARTBEAT_ENV = "SINGA_HEARTBEAT_FILE"


def touch_heartbeat(path) -> None:
    """Touch a heartbeat file (mtime = now); no-op on a falsy path.
    Never raises: a full disk or a removed directory must not crash the
    process the heartbeat exists to protect. The serving `Frontend`
    touches it once per scheduler turn, and the spool server touches
    the router's own heartbeat file through it."""
    if not path:
        return
    try:
        with open(path, "ab"):
            pass
        os.utime(path, None)
    except OSError:
        pass
