"""Every `torch.distributed` collective the port issues is seen by
shardlint's recorder (counterpart of tests/test_shardlint.py's
`test_direct_lax_collectives_stay_in_the_choke_modules`).

An AST scan of singa_tpu_torch/: each call of a collective through
`torch.distributed` (under any alias) or through communicator's own
all-gather and reduce-scatter names must sit in a choke module, in a
function that also calls a recorder hook (`analysis.trace.record`, or
`_Ring.record`), or be one of the exempt sites below, each with its
reason. A new collective outside them fails, naming file:line.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "singa_tpu_torch"

#: the torch.distributed calls that move data between ranks
COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_single",
    "reduce_scatter", "reduce_scatter_tensor", "reduce_scatter_single",
    "all_to_all", "all_to_all_single", "broadcast", "batch_isend_irecv",
    "isend", "irecv", "send", "recv", "barrier", "monitored_barrier",
    "all_gather_object", "broadcast_object_list", "gather", "scatter",
    "reduce", "gather_object", "scatter_object_list"}
#: communicator's names for the backends' own gather and scatter
ALIASES = {"_all_gather_into_tensor", "_reduce_scatter_tensor"}

#: the modules that may issue collectives: every call there is hooked
CHOKE_MODULES = {
    "singa_tpu_torch/communicator.py",
    "singa_tpu_torch/parallel/tp.py",
    "singa_tpu_torch/parallel/ring.py",
    "singa_tpu_torch/parallel/ulysses.py",
    "singa_tpu_torch/serving/engine.py",
    "singa_tpu_torch/native/hlo_runtime.py",
}

#: (file, function) -> why its collective is not recorded
EXEMPT = {
    ("singa_tpu_torch/distributed.py", "host_slices"):
        "setup: the hosts' names, gathered once before any mesh exists",
    ("singa_tpu_torch/analysis/trace.py", "merged"):
        "the recorder's own merge of the ranks' records, after the step",
    ("singa_tpu_torch/native/hlo_bridge.py", "run_replicated"):
        "the replica check after a native step: not part of the module",
    ("singa_tpu_torch/examples/serve_gpt.py", "_spawn_tp"):
        "the serving CLI: rank 0 waits for its spawned ranks",
    ("singa_tpu_torch/examples/serve_gpt.py", "_tp_rank"):
        "the serving CLI: a spawned rank's start barrier",
    ("singa_tpu_torch/examples/serve_gpt.py", "_serve"):
        "the serving CLI: rank 0's pretrained weights, sent once",
}


def _dist_names(tree):
    """The names `torch.distributed` is bound to in a module."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.asname or a.name for a in node.names
                         if a.name == "torch.distributed")
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            names.update(a.asname or a.name for a in node.names
                         if a.name == "distributed")
    return names


def _is_collective(call, dist_names) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id in ALIASES
    if not isinstance(f, ast.Attribute) or f.attr not in COLLECTIVES:
        return False
    v = f.value
    if isinstance(v, ast.Name):
        return v.id in dist_names
    # torch.distributed.<collective>(...)
    return (isinstance(v, ast.Attribute) and v.attr == "distributed"
            and isinstance(v.value, ast.Name) and v.value.id == "torch")


def _is_hook(call) -> bool:
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
    return name == "record"


def collective_sites():
    """[(file, line, function, hooked)] of every collective call."""
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = str(path.relative_to(ROOT))
        tree = ast.parse(path.read_text(), rel)
        names = _dist_names(tree) | {"dist"}

        def visit(node, fn):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    visit(child, child)
                    continue
                if isinstance(child, ast.Call) and _is_collective(
                        child, names):
                    hooked = fn is not None and any(
                        isinstance(n, ast.Call) and _is_hook(n)
                        for n in ast.walk(fn))
                    out.append((rel, child.lineno,
                                getattr(fn, "name", "<module>"), hooked))
                visit(child, fn)

        visit(tree, None)
    return out


SITES = collective_sites()


def test_the_scan_finds_the_known_call_sites():
    files = {f for f, *_ in SITES}
    assert CHOKE_MODULES <= files, sorted(files)
    assert len(SITES) >= 25, SITES


@pytest.mark.parametrize("site", SITES, ids=lambda s: f"{s[0]}:{s[1]}")
def test_every_collective_is_recorded_or_exempt(site):
    rel, line, fn, hooked = site
    if (rel, fn) in EXEMPT:
        return
    assert rel in CHOKE_MODULES, (
        f"{rel}:{line} ({fn}) issues a collective outside the choke "
        f"modules {sorted(CHOKE_MODULES)}: route it through one")
    assert hooked, (
        f"{rel}:{line} ({fn}) issues a collective with no "
        f"analysis.trace.record beside it: shardlint would not see it")


def test_every_exempt_site_still_exists():
    present = {(f, fn) for f, _, fn, _ in SITES}
    assert set(EXEMPT) <= present, set(EXEMPT) - present
