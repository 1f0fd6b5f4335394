"""Shardlint's command line: lint every registry case, write the JSON
report (counterpart of singa_tpu/analysis/__main__.py).

    python -m singa_tpu_torch.analysis [--devices N] [--case NAME ...]
                                       [--out PATH] [--list] [--hlo]
                                       [--device D]

With `--devices 1` (the default) the cases run over a world-1 group on
the card (NCCL), or with `--device cpu` over gloo. With `--devices N >
1 --device cpu` they run as N gloo ranks on the CPU, one process each
(`utils.virtual`, the reference's virtual mesh); rank 0 prints and
writes. Each case's model (or engine) is built, one step is recorded
and the rules R1, R2, R4 and R5 run over it; the state is put back.
Prints an `OK`/`FAIL` block a case and `[shardlint] k/n clean`; exits 0
when every case is clean. `--list` names the applicable cases and the
reference's cases the port does not build.

With `--hlo` the sweep also lints the raw-HLO registry
(`cases.iter_hlo_cases`: `native_dp`, the C++-emitted native DP module
of the world's replica count) under rule R7, printing each case's text
census beside the emitter's declared one; `--hlo --list` adds its names
and the reference's raw shard_map cases, which make no module text here
(`cases.HLO_NOT_PORTED`). `--hlo --case native_dp` lints it alone.
"""

from __future__ import annotations

import argparse
import json
import sys

_MODULE = "singa_tpu_torch.analysis"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=f"python -m {_MODULE}",
        description="lint every registry case (rules R1, R2, R4, R5; "
                    "R7 on the raw-HLO cases with --hlo)")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks: 1 (the default) over a world-1 group on "
                         "--device; N > 1 as N gloo processes on the CPU")
    ap.add_argument("--out", default="shardlint_report.json",
                    help="JSON report path ('' to skip writing)")
    ap.add_argument("--case", action="append", default=[],
                    help="lint only these case names (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list the applicable case names and exit")
    ap.add_argument("--hlo", action="store_true",
                    help="also lint the raw-HLO surfaces (the native DP "
                         "module) under R7 and print each one's "
                         "StableHLO collective census")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def _census_line(rep) -> str:
    """The text's collective census beside the declared one."""
    ev = rep.hlo or {}

    def fmt(d):
        return ",".join(f"{k}={v}" for k, v in sorted(d.items())) or "-"

    line = f"    hlo census: found[{fmt(ev.get('census') or {})}]"
    if ev.get("expected") is not None:
        line += f" expected[{fmt(ev['expected'])}]"
    return line


def _list(n: int, hlo: bool) -> int:
    from singa_tpu_torch.analysis import cases

    for c in cases.iter_cases(n):
        print(c.name)
    if hlo:
        for c in cases.iter_hlo_cases(n):
            print(c.name)
    for name, why in cases.NOT_PORTED.items():
        print(f"{name}: not ported ({why})")
    if hlo:
        for name, why in cases.HLO_NOT_PORTED.items():
            print(f"{name}: not ported ({why})")
    return 0


def _lint(names, out_path: str, hlo: bool) -> int:
    from singa_tpu_torch import analysis, autograd
    from singa_tpu_torch import distributed as dist_mod
    from singa_tpu_torch.analysis import cases

    n, me = dist_mod.process_count(), dist_mod.process_index()
    registry = cases.iter_cases(n)
    hlo_registry = cases.iter_hlo_cases(n) if hlo else []
    if names:
        unknown = names - {c.name for c in registry + hlo_registry}
        if unknown:
            raise SystemExit(f"[shardlint] unknown --case name(s) for {n} "
                             f"devices: {sorted(unknown)}; see --list")
    reports, failed = [], 0
    for case in registry:
        if names and case.name not in names:
            continue
        autograd.set_autocast(False)  # process-global; cases share it
        built = case.build(list(range(n)))
        if built is None:
            continue  # this rank is outside the case's mesh
        model, args = built
        rep = analysis.lint_step(model, *args, target=case.name)
        del model, built
        reports.append(rep)
        failed += 0 if rep.ok else 1
        if me == 0:
            print(rep.summary(), flush=True)
    for case in hlo_registry:
        if names and case.name not in names:
            continue
        rep = analysis.run_rules(case.trace(list(range(n))),
                                 rules=analysis.HLO_RULES, target=case.name)
        reports.append(rep)
        failed += 0 if rep.ok else 1
        if me == 0:
            print(rep.summary(), flush=True)
            print(_census_line(rep), flush=True)
    if me != 0:
        return 1 if failed else 0
    payload = {"devices": n, "cases": len(reports), "failed": failed,
               "skipped": 0, "hlo": hlo, "rules": analysis.RULES,
               "reports": [r.to_json() for r in reports]}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"[shardlint] report -> {out_path}")
    print(f"[shardlint] {len(reports) - failed}/{len(reports)} clean",
          flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    from singa_tpu_torch.utils import virtual

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    if args.devices < 1:
        raise SystemExit(f"--devices {args.devices} must be >= 1")
    if args.list:
        return _list(args.devices, args.hlo)
    if args.devices > 1 and args.device != "cpu":
        raise SystemExit(f"--devices {args.devices} runs {args.devices} "
                         f"gloo ranks on the CPU: pass --device cpu")
    virtual.ensure(args.devices if args.devices > 1 else 0, _MODULE, argv,
                   args.device)
    from singa_tpu_torch import distributed as dist_mod

    if virtual.child_rank() is None:  # world 1: a group of one
        dist_mod.init(device=args.device)
    try:
        return _lint(set(args.case), args.out, args.hlo)
    finally:
        dist_mod.shutdown()


if __name__ == "__main__":
    sys.exit(main())
