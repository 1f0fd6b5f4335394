"""The lint registry: every model-level parallel recipe the port builds
(counterpart of singa_tpu/analysis/cases.py).

The model cases are the strategies runner's
(`examples.parallel_strategies.iter_cases`: the reference's names,
meshes, widths and seeds), so "every case lints clean" is a statement
about the objects the runner trains. To them this adds the reference's
resilient and supervised 3-D steps and its four sharded serving steps,
whose engines carry their own `declared_schedule` and
`lint_artifacts`.

The reference's six `gpt_bench_*` cases are built from `bench.py`'s
recipe, which the port has not ported (ROADMAP item 9, `bench_torch.py`);
`NOT_PORTED` names them, and the runner's `--list` prints them as such.

The raw-HLO registry (`iter_hlo_cases`, linted under R7 by `--hlo`)
holds `native_dp`, the C++-emitted native DP module of the strategies
runner's recipe (`parallel_strategies.native_dp_step`). The reference's
other five raw-HLO cases lint the module text of its raw shard_map
steps; the port's `parallel.raw_steps` are PyTorch functions that make
no module text, and `HLO_NOT_PORTED` names them.

`build(devs)` gives (the compiled model or engine, its step arguments)
on the ranks `devs`, or None on a rank outside the case's mesh (the
serving cases' mesh is the first two ranks), which then takes no part.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

from singa_tpu_torch.examples.parallel_strategies import LintCase
from singa_tpu_torch.parallel.mesh import MODEL_AXIS
from singa_tpu_torch.parallel.raw_steps import RAW_STEP_BUILDERS

__all__ = ["LintCase", "HloCase", "iter_cases", "iter_hlo_cases",
           "build_case", "NOT_PORTED", "HLO_NOT_PORTED"]

#: the reference's remat policies of its bench grid
_REMAT_POLICIES = ("none", "per_block", "dots_saveable")

#: the reference's cases the port cannot build, and why
NOT_PORTED = {
    **{f"gpt_bench_{r}": "bench.py's gpt recipe is not ported (ROADMAP "
                         "item 9, bench_torch.py)" for r in _REMAT_POLICIES},
    **{f"gpt_bench_3d_{r}": "bench.py's gpt recipe is not ported "
                            "(ROADMAP item 9, bench_torch.py)"
       for r in _REMAT_POLICIES},
}

#: the reference's raw-HLO cases the port cannot lint, and why
HLO_NOT_PORTED = {
    name: "the port's raw shard_map step is a PyTorch function and makes "
          "no StableHLO module text" for name in RAW_STEP_BUILDERS}


def _resilient_3d(devs):
    """The 3-D scan recipe with the NaN/Inf sentinel attached (dynamic
    loss scale, the all-finite check on the global norm's reduction,
    the `torch.where`-guarded update): it must add no collective of its
    own and keep every state in place."""
    from singa_tpu_torch.examples import parallel_strategies as ps
    from singa_tpu_torch.resilience.sentinel import GradSentinel

    m, args = ps.build_case("scan_3d", devs)
    m._optimizer.set_sentinel(
        GradSentinel(init_scale=2.0 ** 4, growth_interval=4))
    return m, args


def _supervised_3d(devs):
    """`resilient_3d` as the Supervisor drives it: the spike detector
    lives on the host and reads only the loss, so the step is the
    resilient one's."""
    from singa_tpu_torch.resilience.anomaly import SpikeDetector

    m, args = _resilient_3d(devs)
    m._spike_detector = SpikeDetector()
    return m, args


def _serve_mesh(devs):
    """The (2,) model mesh over the first two ranks; None outside it."""
    from singa_tpu_torch.parallel import mesh as mesh_module

    mesh = mesh_module.get_mesh((2,), (MODEL_AXIS,), devices=list(devs)[:2],
                                allow_outside=True)
    return mesh if mesh.member else None


def _serve_model(seed: int):
    from singa_tpu_torch.examples import parallel_strategies as ps
    from singa_tpu_torch.models.gpt import gpt_small

    m = gpt_small(vocab_size=61, d_model=32, num_layers=3, num_heads=4,
                  max_len=32, dropout=0.0, device=ps._dev(),
                  generator=ps._gen(seed))
    m._ensure_initialized(32)
    return m


def _serve_tp(spec: bool):
    """A tp=2 `ServingEngine` (with `spec`, a `SpeculativeEngine` whose
    draft shards the same axis): target 3 blocks, draft 1, spec_k 4."""

    def build(devs):
        from singa_tpu_torch.examples import parallel_strategies as ps
        from singa_tpu_torch.models.gpt import gpt_draft
        from singa_tpu_torch.serving import ServingEngine, SpeculativeEngine

        mesh = _serve_mesh(devs)
        if mesh is None:
            return None
        m = _serve_model(20)
        kw = dict(slots=2, block_size=8, window=32, mesh=mesh,
                  tp_axis=MODEL_AXIS)
        if not spec:
            return ServingEngine(m, **kw), ()
        dm = gpt_draft(m, d_model=16, num_layers=1, num_heads=2,
                       device=ps._dev(), generator=ps._gen(21))
        return SpeculativeEngine(m, dm, spec_k=4, **kw), ()

    return build


def _serve_prefix_warm(devs):
    """A tp=2 engine with `prefix_cache=True` holding a warm admission:
    the decode step linted serves owned and shared pages."""
    import numpy as np

    from singa_tpu_torch.serving import ServingEngine
    from singa_tpu_torch.serving.engine import Request

    mesh = _serve_mesh(devs)
    if mesh is None:
        return None
    eng = ServingEngine(_serve_model(22), slots=2, block_size=8, window=32,
                        mesh=mesh, tp_axis=MODEL_AXIS, prefix_cache=True)
    rng = np.random.default_rng(23)
    shared = rng.integers(0, 61, size=16).astype(np.int32)

    def sfx(n):
        return rng.integers(0, 61, size=n).astype(np.int32)

    cold = Request("cold", np.concatenate([shared, sfx(3)]), 4)
    warm = Request("warm", np.concatenate([shared, sfx(5)]), 4)
    eng.admit(cold)
    eng.admit(warm)
    if warm.cached_tokens != 16:  # else this would lint a cold engine
        raise RuntimeError(f"the warm admission cached "
                           f"{warm.cached_tokens} tokens, not 16")
    return eng, ()


def _serve_chunked(devs):
    """A tp=2 engine whose admission took the staged path: a chunked
    `begin_prefill_async`, one chunk an `advance_prefill`, then
    `finish_prefill`."""
    import numpy as np

    from singa_tpu_torch.serving import ServingEngine
    from singa_tpu_torch.serving.engine import Request

    mesh = _serve_mesh(devs)
    if mesh is None:
        return None
    eng = ServingEngine(_serve_model(26), slots=2, block_size=8, window=32,
                        mesh=mesh, tp_axis=MODEL_AXIS)
    prompt = np.random.default_rng(27).integers(0, 61, size=20).astype(
        np.int32)
    ticket, err = eng.begin_prefill_async([Request("c0", prompt, 4)],
                                          chunked=True)
    if err is not None or ticket is None or not ticket.work:
        raise RuntimeError(f"the chunked admission did not stage: {err}")
    while ticket.work:
        eng.advance_prefill(ticket, max_chunks=1)
    eng.finish_prefill(ticket)
    return eng, ()


def iter_cases(n_devices: int) -> List[LintCase]:
    """Every case applicable on `n_devices` ranks, in the reference's
    order (the strategies runner's model cases, then the resilient,
    supervised and serving ones)."""
    from singa_tpu_torch.examples import parallel_strategies as ps

    cases = ps.iter_cases(n_devices)
    at = [c.name for c in cases].index("sp_gpt")  # sp_gpt fits any world
    cases[at:at] = [
        LintCase("resilient_3d", _resilient_3d, min_devices=4, divides=4),
        LintCase("supervised_3d", _supervised_3d, min_devices=4, divides=4)]
    cases += [
        LintCase("serve_tp", _serve_tp(False), min_devices=2),
        LintCase("serve_tp_spec", _serve_tp(True), min_devices=2),
        LintCase("serve_prefix_warm", _serve_prefix_warm, min_devices=2),
        LintCase("serve_chunked", _serve_chunked, min_devices=2),
    ]
    return [c for c in cases if c.applicable(n_devices)]


def build_case(name: str, devs):
    """Build case `name` on the ranks `devs` (KeyError when the world
    does not admit it)."""
    for c in iter_cases(len(devs)):
        if c.name == name:
            return c.build(devs)
    raise KeyError(f"no case {name!r} for {len(devs)} devices")


# -- the raw-HLO registry ---------------------------------------------------------


@dataclasses.dataclass
class HloCase:
    """A lint subject that is StableHLO module text: `trace(devs)` gives
    the `StepTrace` R7 runs over."""

    name: str
    trace: Callable[[Sequence], Optional[object]]


def _native_dp_trace(devs):
    """The native DP module of `len(devs)` replicas (the strategies
    runner's recipe, fp32 wire): its text and its declared census."""
    from singa_tpu_torch.analysis import hlo
    from singa_tpu_torch.examples.parallel_strategies import native_dp_step

    step, _ = native_dp_step(len(devs))
    return hlo.trace_native_module(step, target="native_dp")


def iter_hlo_cases(n_devices: int) -> List[HloCase]:
    """Every raw-HLO subject the port has: the native DP module."""
    return [HloCase("native_dp", _native_dp_trace)]
