"""Shardlint's rules R1, R2, R4 and R5 over a recorded step, and R7 over
module text (counterpart of singa_tpu/analysis/rules.py).

Each rule reads a `trace.StepTrace` and appends `report.Violation`s.
The expected values come from metadata the owning modules declare
(`mesh.COMPATIBLE_ROLE_PAIRS`, `declared_schedule` of the stacks and
engines), so the analyzer cannot drift from the code it audits.

- R1 reads the declared axis roles and every recorded call's axis.
- R2 counts each block scope's forward records by (op, axis), on every
  rank, against the stack's per-block schedule; a declared `census`
  (the serving engines' whole step) is checked over the whole step.
  Where the reference matches a forward scan of the stack's length,
  the port counts the records made inside the stack's own block scopes
  (`trace.block`), so the count is exact per block.
- R4 joins each ppermute's sends from every rank (the k-th ppermute of
  a group on each rank is one rotation) into a permutation and holds it
  to one cycle over the axis (`check_ring_perm`).
- R5 holds every state tensor's address, dtype and shape across the
  capture and a replay (two calls where nothing is captured). A
  re-bound `.data` is the reference's dropped donation: the captured
  graph would go on reading the old storage. Values may stay put: a
  step the sentinel skips moves none.

- R7 runs on a subject with StableHLO module text (the native training
  step, `hlo.trace_native_module`): every collective's replica groups
  must be well formed for the module's own `mhlo.num_replicas x
  mhlo.num_partitions` world, and the text's census must equal the one
  its emitter declares.

R3 and R6 read a jaxpr's shard taint and reconcile the module with the
jaxpr; PyTorch gives a step neither, so they are not ported and asking
for them raises. So does asking for R7 on a subject without text (a
PyTorch step).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional, Tuple

from singa_tpu_torch.analysis import hlo as hlo_mod
from singa_tpu_torch.analysis.report import Report, Violation
from singa_tpu_torch.analysis.trace import StepTrace, census

__all__ = ["run_rules", "select_rules", "check_ring_perm", "DEFAULT_RULES",
           "HLO_RULES", "rule_r1", "rule_r2", "rule_r4", "rule_r5",
           "rule_r7"]

DEFAULT_RULES = ("R1", "R2", "R4", "R5")
#: the rules of a subject that is module text (`--hlo`)
HLO_RULES = ("R7",)

#: why the reference's other rules have no torch counterpart
_NOT_PORTED = {
    "R3": "R3 (cross-shard-sum) is a shard-taint analysis over the "
          "step's jaxpr; a PyTorch step has no jaxpr to read",
    "R6": "R6 (hlo-census-conformance) reconciles the lowered StableHLO "
          "module with the step's jaxpr; a PyTorch step has neither",
}
#: why R7 refuses a subject without module text
_NO_TEXT = ("R7 (raw-hlo-surface) reads StableHLO module text; a PyTorch "
            "step makes none (lint the native training step through "
            "hlo.trace_native_module)")


def _fmt_sched(counts: Dict[Tuple[str, str], int]) -> Dict[str, int]:
    return {f"{op}@{ax}": n for (op, ax), n in sorted(counts.items())}


# -- R1: axis liveness and role exclusivity ---------------------------------------


def rule_r1(trace: StepTrace, report: Report) -> None:
    from singa_tpu_torch.parallel.mesh import COMPATIBLE_ROLE_PAIRS

    if trace.trace_error is not None:
        report.violations.append(Violation(
            "R1", f"the step failed: a collective names an axis the "
                  f"step's mesh does not carry: {trace.trace_error}"))
        return
    mesh = trace.mesh
    if mesh is None:
        return  # a single-process step: no axes to get wrong
    avail = set(mesh.axis_names)
    for ax, roles in sorted(trace.axis_roles.items()):
        if ax not in avail:
            report.violations.append(Violation(
                "R1",
                f"declared {sorted(roles)} axis {ax!r} is not on the "
                f"mesh {tuple(mesh.axis_names)}: the scheme silently "
                f"degrades to its dense path (axis-name typo?)",
                subject=ax))
        rl = sorted(roles)
        for i in range(len(rl)):
            for j in range(i + 1, len(rl)):
                if frozenset({rl[i], rl[j]}) not in COMPATIBLE_ROLE_PAIRS:
                    report.violations.append(Violation(
                        "R1",
                        f"axis {ax!r} is claimed by two parallelism "
                        f"roles ({rl[i]} and {rl[j]}): one axis cannot "
                        f"carry both schemes' shards; put them on "
                        f"distinct mesh axes",
                        subject=ax))
    seen = set()
    for recs in trace.records:
        for r in recs:
            if r.axis is not None and r.axis not in avail and (
                    r.axis not in seen):
                seen.add(r.axis)
                report.violations.append(Violation(
                    "R1",
                    f"recorded {r.op} names axis {r.axis!r}, absent from "
                    f"the mesh {tuple(mesh.axis_names)}",
                    subject=r.axis))


# -- R2: schedule conformance ---------------------------------------------------------


def _block_counts(records, label: Optional[str], axes) -> Dict[int, Counter]:
    """{block index: Counter((op, axis))} of the forward records inside
    the scopes labelled `label`, over `axes`."""
    out: Dict[int, Counter] = {}
    for r in records:
        if (r.phase == "forward" and r.block is not None
                and r.block[0] == label and r.axis in axes):
            out.setdefault(r.block[1], Counter())[(r.op, r.axis)] += 1
    return out


def _check_census(stack, sched: Dict, trace: StepTrace,
                  report: Report) -> None:
    """A declared `census` (total (op, axis) calls of the whole step,
    the serving engines' epilogue gather included) against each rank's
    records."""
    declared = sched.get("census")
    if not declared:
        return
    keys = frozenset(declared)
    for rank, recs in enumerate(trace.records):
        found = dict(Counter((r.op, r.axis) for r in recs
                             if (r.op, r.axis) in keys))
        if found == declared:
            continue
        diff = []
        for key in sorted(set(declared) | set(found)):
            e, f = declared.get(key, 0), found.get(key, 0)
            if e != f:
                diff.append(f"{key[0]}@{key[1]}: declared {e} per step, "
                            f"found {f}")
        if report.schedule is None:
            report.schedule = {"expected": _fmt_sched(declared),
                               "found": _fmt_sched(found)}
        report.violations.append(Violation(
            "R2",
            f"whole-step collective census does not match the declared "
            f"schedule on rank {rank} of the mesh: " + "; ".join(diff),
            subject=type(stack).__name__))
        return


def rule_r2(trace: StepTrace, report: Report) -> None:
    # the overlapped ZeRO-3 stack issues block k+1's gathers inside
    # block k's scope (the last block re-gathers block 0): each block
    # still issues len(STACKED); the prologue gather is outside every
    # block, as it is outside the reference's scan
    if not trace.records or trace.mesh is None or not trace.stacks:
        return
    for stack in trace.stacks:
        sched = stack.declared_schedule(trace.mesh)
        _check_census(stack, sched, trace, report)
        expected = dict(sched["per_block"])
        if not expected:
            continue  # no sharded axis on this mesh: nothing to check
        axes = frozenset(ax for _, ax in expected)
        label = trace.scopes.get(id(stack))
        n = int(sched["n_blocks"])
        per_rank = [_block_counts(recs, label, axes)
                    for recs in trace.records]
        if not any(per_rank):
            report.schedule = {"expected": _fmt_sched(expected),
                               "found": {}}
            report.violations.append(Violation(
                "R2",
                f"stack declares the per-block schedule "
                f"{_fmt_sched(expected)} but none of its {n} blocks "
                f"recorded those collectives: the sharded block body is "
                f"not running",
                subject=type(stack).__name__))
            continue
        bad = []
        for rank, counts in enumerate(per_rank):
            for i in range(n):
                found = dict(counts.get(i, {}))
                if found != expected:
                    bad.append((rank, i, found))
            extra = sorted(set(counts) - set(range(n)))
            if extra:
                bad.append((rank, extra[0], dict(counts[extra[0]])))
        first = dict(per_rank[0].get(0, {}))
        if not bad:
            if report.schedule is None:
                report.schedule = {"expected": _fmt_sched(expected),
                                   "found": _fmt_sched(first)}
            continue
        rank, i, found = bad[0]
        if report.schedule is None or (
                report.schedule["expected"] == report.schedule["found"]):
            report.schedule = {"expected": _fmt_sched(expected),
                               "found": _fmt_sched(found)}
        diff = []
        for key in sorted(set(expected) | set(found)):
            e, f = expected.get(key, 0), found.get(key, 0)
            if e != f:
                diff.append(f"{key[0]}@{key[1]}: expected {e} per block, "
                            f"found {f}")
        report.violations.append(Violation(
            "R2",
            f"per-block collective schedule does not match the declared "
            f"recipe (block {i} on rank {rank} of the mesh; {len(bad)} "
            f"block(s) differ): " + "; ".join(diff),
            subject=type(stack).__name__))


# -- R4: ring completeness --------------------------------------------------------------


def check_ring_perm(perm, extent: int) -> Optional[str]:
    """None if `perm` is one single cycle covering 0..extent-1, else
    the reason it is not (the reference's, its unit surface)."""
    perm = [tuple(p) for p in perm]
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(perm) != extent:
        return (f"{len(perm)} links for axis extent {extent} — "
                f"{'missing' if len(perm) < extent else 'extra'} links "
                f"leave some chip without some block")
    if sorted(srcs) != list(range(extent)) or \
            sorted(dsts) != list(range(extent)):
        return ("sources/destinations are not a permutation of the "
                "axis — some chip sends or receives twice")
    nxt = dict(perm)
    node, seen = 0, set()
    while node not in seen:
        seen.add(node)
        node = nxt[node]
    if len(seen) != extent:
        return (f"permutation splits into cycles (cycle through 0 "
                f"covers {len(seen)}/{extent} chips) — blocks never "
                f"reach the other cycle's chips")
    return None


def _rotations(trace: StepTrace):
    """{(axis, group ranks, k): [(source, destination), ...]}: the k-th
    ppermute of each group, joined over the ranks that issued it."""
    out: Dict = {}
    for recs in trace.records:
        nth: Counter = Counter()
        for r in recs:
            if r.op != "ppermute" or r.peer is None:
                continue
            k = nth[(r.axis, r.ranks)]
            nth[(r.axis, r.ranks)] += 1
            out.setdefault((r.axis, r.ranks, k), []).append(r.peer)
    return out


def rule_r4(trace: StepTrace, report: Report) -> None:
    if not trace.records or trace.mesh is None:
        return
    shape = trace.mesh.shape
    seen = set()
    for (ax, _ranks, _k), pairs in _rotations(trace).items():
        if ax not in shape:
            continue  # R1's finding
        perm = tuple(sorted(pairs))
        if (ax, perm) in seen:
            continue
        seen.add((ax, perm))
        why = check_ring_perm(perm, int(shape[ax]))
        if why:
            report.violations.append(Violation(
                "R4",
                f"ppermute over {ax!r} with perm {list(perm)} is not one "
                f"full cycle: {why}",
                subject=ax))


# -- R5: in-place state ------------------------------------------------------------------


def rule_r5(trace: StepTrace, report: Report) -> None:
    st = trace.state
    if not st or len(st.get("snapshots", ())) < 2:
        return
    snaps = st["snapshots"]
    flagged = set()
    for before, after in zip(snaps, snaps[1:]):
        for name, was in before.items():
            if name in flagged:
                continue
            now = after.get(name)
            if now == was:
                continue
            flagged.add(name)
            if now is None:
                what = "left the step's state"
            elif now[0] != was[0]:
                what = (f"was re-bound to new storage (data_ptr "
                        f"{was[0]:#x} -> {now[0]:#x})")
            else:
                what = (f"changed from {was[1]}{list(was[2])} to "
                        f"{now[1]}{list(now[2])}")
            report.violations.append(Violation(
                "R5",
                f"state tensor {name} {what} across {st['across']}: a "
                f"captured step would go on reading and writing the old "
                f"storage (the reference's dropped donation)",
                subject=name))


# -- R7: the raw-HLO surface ------------------------------------------------------------


def _hlo_evidence(trace: StepTrace, report: Report) -> Optional[Dict]:
    """Fill (once) and return `report.hlo`: the text's collective census
    beside the emitter's declared one."""
    if report.hlo is None and trace.lowered_text:
        expected = None
        if trace.hlo_declared is not None:
            expected = {k: int(v) for k, v in trace.hlo_declared.items()
                        if v}
        report.hlo = {"census": hlo_mod.hlo_census(trace.lowered_text),
                      "expected": expected}
    return report.hlo


def rule_r7(trace: StepTrace, report: Report) -> None:
    """Every collective op instance in the module text must carry well
    formed `replica_groups` / `source_target_pairs` for the module's own
    `mhlo.num_replicas x num_partitions` world, and an emitter that
    declares its census (`NativeTrainStep.declared_hlo_census`) must
    match it: a dropped gradient sync is numerically silent on each
    replica, and only this cross-check sees it."""
    if not trace.lowered_text:
        return
    n_dev = hlo_mod.module_device_count(trace.lowered_text)
    seen = set()
    for col in hlo_mod.hlo_collectives(trace.lowered_text):
        for why in hlo_mod.check_collective(col, n_dev):
            key = (col.op, why)
            if key in seen:
                continue
            seen.add(key)
            report.violations.append(Violation(
                "R7", f"{col.op} (text offset {col.pos}): {why}",
                subject=col.op))
    if trace.hlo_declared is None:
        return
    ev = _hlo_evidence(trace, report)
    declared, found = ev["expected"], ev["census"]
    if declared == found:
        return
    diff = []
    for op in sorted(set(declared) | set(found)):
        e, f = declared.get(op, 0), found.get(op, 0)
        if e != f:
            diff.append(f"{op}: emitter declares {e}, module carries {f}")
    report.violations.append(Violation(
        "R7",
        "emitted module does not match the emitter's declared HLO census "
        "— " + "; ".join(diff) + " (a gradient would silently skip "
        "cross-replica averaging)",
        subject=trace.target))


# -----------------------------------------------------------------------------------------

_RULE_FNS = {"R1": rule_r1, "R2": rule_r2, "R4": rule_r4, "R5": rule_r5,
             "R7": rule_r7}


def select_rules(rules=None, trace: Optional[StepTrace] = None
                 ) -> Tuple[str, ...]:
    """`rules` (default `DEFAULT_RULES`) as a tuple. Asking for R3 or R6
    raises ValueError: there is no torch object for them to read; so
    does asking for R7 without a `trace` that carries module text."""
    rules = tuple(rules or DEFAULT_RULES)
    for rid in rules:
        if rid in _NOT_PORTED:
            raise ValueError(f"rule {rid} is not ported: "
                             f"{_NOT_PORTED[rid]}")
        if rid not in _RULE_FNS:
            raise ValueError(f"unknown rule {rid!r}; the port has "
                             f"{DEFAULT_RULES + HLO_RULES}")
        if rid == "R7" and (trace is None or not trace.lowered_text):
            raise ValueError(f"rule R7 needs module text: {_NO_TEXT}")
    return rules


def run_rules(trace: StepTrace, rules=None,
              target: Optional[str] = None) -> Report:
    """The report of `rules` (`select_rules`) over `trace`."""
    rules = select_rules(rules, trace)
    report = Report(target=target or trace.target)
    report.collectives = census(trace.local_records())
    _hlo_evidence(trace, report)  # the text's census on a clean run too
    for rid in rules:
        _RULE_FNS[rid](trace, report)
    return report
