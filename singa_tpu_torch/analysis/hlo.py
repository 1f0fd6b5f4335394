"""Shardlint's raw-HLO half: StableHLO module text as a lint subject
(counterpart of the text-level part of singa_tpu/analysis/hlo.py).

A PyTorch step makes no module text, but the native training step does:
`native.hlo_bridge.lower_train_step` has `native/hlo_core.cc` write the
whole SGD step as StableHLO, and `hlo_runtime` runs exactly that text.
This module reads the text's collectives (`stablehlo.all_reduce`,
`all_gather`, `reduce_scatter`, `collective_permute`, `all_to_all`)
with their `replica_groups` / `source_target_pairs` / `channel_handle`
attributes, so rule R7 (`rules.rule_r7`) can check every collective's
device groups against the module's own `mhlo.num_replicas x
mhlo.num_partitions` world, and the text's census against the one the
emitter declares (`NativeTrainStep.declared_hlo_census`).

The reference's jaxpr-reading half (`dce_jaxpr`, `expected_hlo_census`,
R6) and its compiled-header reader (`parse_input_output_aliases`, the R5
upgrade) read objects PyTorch does not make and are not ported, nor is
`trace_raw_step`: the port's raw shard_map steps are PyTorch functions
with no module text.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

__all__ = [
    "HLO_COLLECTIVE_OPS", "HloCollective", "hlo_collectives", "hlo_census",
    "module_device_count", "check_collective", "trace_native_module",
]

#: the StableHLO collective vocabulary
HLO_COLLECTIVE_OPS = ("all_reduce", "all_gather", "reduce_scatter",
                      "collective_permute", "all_to_all")


@dataclasses.dataclass
class HloCollective:
    """One collective op instance parsed out of module text."""

    op: str                         # one of HLO_COLLECTIVE_OPS
    #: parsed replica_groups rows; None when the op carries none (the
    #: flat "one group of every device" default)
    replica_groups: Optional[List[List[int]]] = None
    #: collective_permute's (source, target) links
    source_target_pairs: Optional[List[Tuple[int, int]]] = None
    channel_id: Optional[int] = None
    use_global_device_ids: bool = False
    #: character offset into the module text (error anchoring)
    pos: int = 0


_OP_RE = re.compile(
    r'"?stablehlo\.(' + "|".join(HLO_COLLECTIVE_OPS) + r')"?\s*[(%]')
_DENSE_RE = re.compile(
    r'(replica_groups|source_target_pairs)\s*=\s*dense<(.*?)>\s*:'
    r'\s*tensor<([0-9x]*)xi64>', re.S)
_CHANNEL_RE = re.compile(r'channel_handle[^>]*?handle\s*=\s*(\d+)')
_FUNC_RE = re.compile(r'func\.func\s+(?:public\s+|private\s+)?'
                      r'@([\w.$-]+)')
_CALL_RE = re.compile(r'(?:\bcall\s+|callee\s*=\s*)@([\w.$-]+)')
_MHLO_RE = re.compile(r'mhlo\.num_(replicas|partitions)\s*=\s*(\d+)')


def _parse_dense_i64(body: str, shape: str) -> List[List[int]]:
    """A dense<...> : tensor<RxCxi64> literal as rows. Handles the
    full nested-list form, the splat form (`dense<0>`), and the empty
    form (`dense<>` over tensor<0x0xi64>)."""
    dims = [int(d) for d in shape.split("x") if d]
    body = body.strip()
    if not body:
        return []
    if "[" not in body:
        # splat: every element equals `body`
        val = int(body)
        if len(dims) == 2:
            return [[val] * dims[1] for _ in range(dims[0])]
        return [[val]]
    rows = re.findall(r'\[([0-9,\s-]*)\]', body)
    # findall on "[[a], [b]]" also matches the outer bracket content
    # when there is a single row; keep only innermost (comma/digit) rows
    out = []
    for row in rows:
        row = row.strip()
        if "[" in row:
            continue
        out.append([int(v) for v in row.split(",") if v.strip()])
    return out


def hlo_collectives(text: str) -> List[HloCollective]:
    """Every collective op INSTANCE in the module text, in order. Each
    instance is parsed from the text between its op token and the next
    collective op (attribute dicts never span two collectives; only
    collective ops carry these attrs, so the window is safe)."""
    hits = list(_OP_RE.finditer(text))
    out: List[HloCollective] = []
    for i, m in enumerate(hits):
        end = hits[i + 1].start() if i + 1 < len(hits) else len(text)
        chunk = text[m.start():end]
        col = HloCollective(op=m.group(1), pos=m.start())
        for dm in _DENSE_RE.finditer(chunk):
            rows = _parse_dense_i64(dm.group(2), dm.group(3))
            if dm.group(1) == "replica_groups":
                col.replica_groups = rows
            else:
                col.source_target_pairs = [
                    (r[0], r[1]) for r in rows if len(r) == 2]
        cm = _CHANNEL_RE.search(chunk)
        if cm:
            col.channel_id = int(cm.group(1))
        col.use_global_device_ids = "use_global_device_ids" in chunk
        out.append(col)
    return out


def module_device_count(text: str) -> int:
    """num_replicas x num_partitions from the module's mhlo attrs
    (each defaults to 1 when absent)."""
    counts = {"replicas": 1, "partitions": 1}
    for m in _MHLO_RE.finditer(text):
        counts[m.group(1)] = int(m.group(2))
    return counts["replicas"] * counts["partitions"]



def _functions(text: str) -> Dict[str, str]:
    """func name -> its body text (to the next func.func or EOF). A
    module with no func.func at all is treated as one 'main'."""
    hits = list(_FUNC_RE.finditer(text))
    if not hits:
        return {"main": text}
    out: Dict[str, str] = {}
    for i, m in enumerate(hits):
        end = hits[i + 1].start() if i + 1 < len(hits) else len(text)
        out[m.group(1)] = text[m.start():end]
    return out


def hlo_census(text: str, root: str = "main") -> Dict[str, int]:
    """op name -> STATIC occurrence count reachable from `root`,
    expanding `func.call` sites with multiplicity (jax deduplicates
    repeated sub-jaxprs into private functions called N times; the
    census must count them N times). Scan/while bodies are regions,
    printed once: this is a census of static occurrences."""
    funcs = _functions(text)
    if root not in funcs:
        root = next(iter(funcs))
    memo: Dict[str, Dict[str, int]] = {}

    def census_of(name: str, seen: frozenset) -> Dict[str, int]:
        if name in memo:
            return memo[name]
        if name not in funcs or name in seen:  # unknown / recursive
            return {}
        body = funcs[name]
        counts: Dict[str, int] = {}
        for m in _OP_RE.finditer(body):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        for cm in _CALL_RE.finditer(body):
            callee = cm.group(1)
            for op, n in census_of(callee, seen | {name}).items():
                counts[op] = counts.get(op, 0) + n
        memo[name] = counts
        return counts

    return census_of(root, frozenset())



def check_collective(col: HloCollective, n_devices: int) -> List[str]:
    """Why `col`'s device-set attributes are malformed for a module
    spanning `n_devices` devices (empty == well-formed). The XLA
    contract checked: group members in range and distinct, no device in
    two groups, the groups covering EVERY device (a partial partition
    leaves some chip's collective waiting on peers that never arrive),
    and uniform group sizes for the tiled ops (all_gather /
    reduce_scatter / all_to_all concatenate, so ragged groups change
    the output shape per group)."""
    problems: List[str] = []
    if col.replica_groups is not None and col.replica_groups != []:
        groups = col.replica_groups
        seen: Dict[int, int] = {}
        for gi, g in enumerate(groups):
            if len(set(g)) != len(g):
                problems.append(
                    f"replica_groups group {gi} {g} repeats a device")
            for d in g:
                if not 0 <= d < n_devices:
                    problems.append(
                        f"replica_groups names device {d}, outside the "
                        f"module's {n_devices}-device world")
                elif d in seen and seen[d] != gi:
                    problems.append(
                        f"device {d} appears in replica_groups groups "
                        f"{seen[d]} and {gi} — groups must partition")
                seen.setdefault(d, gi)
        covered = {d for g in groups for d in g}
        missing = sorted(set(range(n_devices)) - covered)
        if missing and covered:
            problems.append(
                f"replica_groups cover {sorted(covered)} but the module "
                f"spans {n_devices} devices — {missing} are in no "
                f"group (their collective never completes)")
        if col.op != "all_reduce" and len({len(g) for g in groups}) > 1:
            problems.append(
                f"{col.op} replica_groups have ragged sizes "
                f"{[len(g) for g in groups]} — tiled collectives need "
                f"uniform groups")
    if col.op == "collective_permute" and col.source_target_pairs:
        pairs = col.source_target_pairs
        srcs = [s for s, _ in pairs]
        dsts = [d for _, d in pairs]
        for d in set(srcs + dsts):
            if not 0 <= d < n_devices:
                problems.append(
                    f"collective_permute names device {d}, outside the "
                    f"module's {n_devices}-device world")
        if len(set(srcs)) != len(srcs):
            problems.append(
                "collective_permute has a duplicate source — a chip "
                "cannot send two blocks on one permute")
        if len(set(dsts)) != len(dsts):
            problems.append(
                "collective_permute has a duplicate target — two chips' "
                "sends collide on one receiver")
    return problems


def trace_native_module(step, target: str = "native_dp"):
    """A C++-emitted `NativeTrainStep` as a `StepTrace`: the module text
    is the whole subject, and the emitter's `declared_hlo_census()` the
    schedule R7 holds it to."""
    from singa_tpu_torch.analysis.trace import StepTrace

    declared = None
    own = getattr(step, "declared_hlo_census", None)
    if callable(own):
        declared = own()
    return StepTrace(target=target, lowered_text=step.text,
                     hlo_declared=declared)
