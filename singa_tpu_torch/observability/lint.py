"""Metric-name lint: every emitted metric name must be declared
(counterpart of singa_tpu/observability/lint.py, run over
singa_tpu_torch/).

1. every key of ``resilience.counters.SUPERVISOR_KEYS`` must have a
   help string in `metrics.HELP`;
2. every metric-name LITERAL emitted anywhere in ``singa_tpu_torch/``
   (``bump("...")``, ``counter("...")``, ``gauge("...")``,
   ``histogram("...")``) must appear in `metrics.HELP` with a
   non-empty help string. An undeclared name would export with no help
   text; declaring it is the fix.

``python -m singa_tpu_torch.observability.lint`` exits 0 on a clean
tree and 1, listing every problem, otherwise.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Dict, List

__all__ = ["check", "scan_emitted_names", "main"]

#: emission sites: the call spellings that put a literal metric name on
#: the wire (counters.bump and the three registry accessors, through any
#: receiver); `\s*` spans the line break of a wrapped call, so the scan
#: runs over whole-file text
_PATTERNS = (
    re.compile(r'\bbump\(\s*"([A-Za-z0-9_:]+)"'),
    re.compile(r'\bcounter\(\s*"([A-Za-z0-9_:]+)"'),
    re.compile(r'\bgauge\(\s*"([A-Za-z0-9_:]+)"'),
    re.compile(r'\bhistogram\(\s*"([A-Za-z0-9_:]+)"'),
)


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scan_emitted_names(root: str = None) -> Dict[str, List[str]]:
    """{metric_name: ["path:line", ...]} for every emission literal
    under `root` (default: the singa_tpu_torch package)."""
    root = root or _package_root()
    repo = os.path.dirname(root)
    found: Dict[str, List[str]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as f:
                text = f.read()
            rel = os.path.relpath(path, repo)
            for pat in _PATTERNS:
                for m in pat.finditer(text):
                    line = text.count("\n", 0, m.start()) + 1
                    found.setdefault(m.group(1), []).append(
                        f"{rel}:{line}")
    return found


def check(root: str = None,
          emitted: Dict[str, List[str]] = None) -> List[str]:
    """Every violation as a readable line; [] means clean. Pass a
    `scan_emitted_names` result as `emitted` to reuse a scan."""
    from singa_tpu_torch.observability.metrics import HELP
    from singa_tpu_torch.resilience.counters import SUPERVISOR_KEYS

    problems: List[str] = []
    for key in SUPERVISOR_KEYS:
        if not HELP.get(key):
            problems.append(
                f"counters.SUPERVISOR_KEYS entry {key!r} has no help "
                f"string in observability.metrics.HELP — every "
                f"supervisor counter must be a declared metric")
    if emitted is None:
        emitted = scan_emitted_names(root)
    for name, sites in sorted(emitted.items()):
        if not HELP.get(name):
            problems.append(
                f"metric {name!r} is emitted at {', '.join(sites)} "
                f"but not declared in observability.metrics.HELP — "
                f"add it with a help string")
    return problems


def main(argv=None) -> int:
    emitted = scan_emitted_names()
    problems = check(emitted=emitted)
    if problems:
        for p in problems:
            print(f"METRIC-LINT: {p}")
        return 1
    print(f"metric-name lint: ok ({len(emitted)} emitted names, all "
          f"declared with help strings)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
