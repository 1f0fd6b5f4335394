"""Bounded transient retry and the shared restart backoff (counterpart of
singa_tpu/resilience/retry.py).

Policy:

- Transient signatures cannot be enumerated, so the filter is inverted:
  deterministic Python error classes (`DETERMINISTIC_ERRORS`: a shape
  mismatch or a misspelled keyword fails the same way on every attempt)
  fail fast, and everything else is retried.
- An out-of-memory error is never retried: the caller's batch-halving
  path owns it, and a retry at the same batch runs out of memory again.
  The reference recognises it by ``RESOURCE_EXHAUSTED`` in the message;
  PyTorch raises ``torch.OutOfMemoryError`` ("CUDA out of memory"), a
  `RuntimeError` that the class test alone would retry, so the port
  fails fast on both (`is_oom`).
- Attempts are bounded (`RETRY_ATTEMPTS` tries in all) with a fixed
  backoff; the last attempt re-raises to the caller.

Every absorbed transient bumps the ``retries`` counter, so a number
measured across a retry says so. `exp_backoff_s` is the one restart
pacing the `Supervisor` and the `Babysitter` share.
"""

from __future__ import annotations

import sys
import time

from singa_tpu_torch.resilience import counters

__all__ = ["RETRY_ATTEMPTS", "RETRY_BACKOFF_S", "DETERMINISTIC_ERRORS",
           "TRANSIENT_SIGNATURES", "OOM_SIGNATURES", "is_oom",
           "retry_transient", "exp_backoff_s"]

#: total tries (not extra retries) per wrapped call
RETRY_ATTEMPTS = 3
RETRY_BACKOFF_S = 5.0

#: error classes that fail identically on every attempt: never retried
DETERMINISTIC_ERRORS = (TypeError, ValueError, AttributeError, KeyError,
                        IndexError, NotImplementedError)

#: message fragments of known-transient failures that override the
#: deterministic-class fast-fail (a transport's tear-down can surface
#: wrapped in a deterministic-classed exception)
TRANSIENT_SIGNATURES = ("remote_compile", "response body closed")

#: message fragments of an out-of-memory error: the reference's XLA
#: status and PyTorch's allocator message
OOM_SIGNATURES = ("RESOURCE_EXHAUSTED", "out of memory")


def is_oom(exc: BaseException) -> bool:
    """True for an out-of-memory error: ``torch.OutOfMemoryError`` (the
    CUDA caching allocator's), or any error whose message carries an
    `OOM_SIGNATURES` fragment."""
    import torch

    oom = getattr(torch, "OutOfMemoryError", None)
    if oom is not None and isinstance(exc, oom):
        return True
    msg = str(exc)
    return any(s in msg for s in OOM_SIGNATURES)


def exp_backoff_s(attempt, base_s=RETRY_BACKOFF_S, factor=2.0,
                  cap_s=120.0):
    """The bounded exponential-backoff delay for restart `attempt`
    (0-based): base * factor^attempt, capped. The supervisor's restarts
    and the babysitter's respawns both pace on it."""
    return min(float(cap_s), float(base_s) * float(factor) ** int(attempt))


def retry_transient(label, fn, attempts=RETRY_ATTEMPTS,
                    backoff_s=RETRY_BACKOFF_S):
    """Call fn(); on a failure that could be transient, back off and
    retry, up to `attempts` tries in all. A deterministic error class
    (unless its message carries a `TRANSIENT_SIGNATURES` fragment), an
    out-of-memory error and the last attempt's failure re-raise."""
    for i in range(attempts):
        try:
            return fn()
        except Exception as e:
            msg = str(e)
            known_transient = any(s in msg for s in TRANSIENT_SIGNATURES)
            if (is_oom(e)
                    or (isinstance(e, DETERMINISTIC_ERRORS)
                        and not known_transient)
                    or i == attempts - 1):
                raise
            counters.bump("retries")
            print(f"# {label}: attempt {i + 1}/{attempts} failed "
                  f"({type(e).__name__}: {e}); retrying in {backoff_s}s",
                  file=sys.stderr)
            time.sleep(backoff_s)
