"""Shardlint on the port: the mutation fixtures (the port's counterparts
of tests/fixtures/bad_graphs.py) and the rank scenario of
tests/test_torch_analysis_ranks.py (`helper_torch_parity._rank_analysis`
runs `rank_analysis` in each gloo rank).

Each fixture builds a clean model, seeds one known bug into it by
patching the code path that carries it while the step is recorded, and
returns (the rule that must flag it, the report):

- `axis_name_typo` (R1): `GPT(seq_axis="sq")` on a (data, sp) mesh; the
  ring never engages.
- `missing_tp_g_guard` (R2): Megatron's "g" all-reduce dropped from the
  scanned tp block.
- `doubled_zero3_gather` (R2): a "defensive" re-slice and re-gather in
  ZeRO-3's per-block gather, numerically the identity: 24 gathers a
  block where 12 are declared.
- `dropped_logits_gather` (R2): the sharded decode step's logits gather
  dropped; each rank picks from its own vocab slice.
- `broken_ring_permutation` (R4): the ring's neighbours taken as
  `index ^ 1` over a 4-rank sequence axis, a consistent split into two
  2-cycles (a dropped closing link would leave a receive waiting on a
  real group; the reference's jaxpr never runs).
- `dropped_donation` (R5): a step that re-stores a weight through bf16
  after the update, re-binding its `.data` to new storage.
"""

from contextlib import contextmanager

import torch

#: fixture -> the rule the reference flags it with
FIXTURES = {
    "axis_name_typo": "R1",
    "missing_tp_g_guard": "R2",
    "doubled_zero3_gather": "R2",
    "dropped_logits_gather": "R2",
    "broken_ring_permutation": "R4",
    "dropped_donation": "R5",
}

#: the registry cases whose schedule is held to the reference's
PARITY_CASES = ("scan_tp", "scan_zero3", "scan_seq")
#: the engines whose declared schedule is held to the reference's
SERVE_CASES = ("serve_tp", "serve_tp_spec")


def _lint(model, args, name):
    from singa_tpu_torch import analysis

    return analysis.lint_step(model, *args, target=f"bad:{name}")


@contextmanager
def _patched(obj, attr, value):
    orig = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def axis_name_typo(devs):
    from singa_tpu_torch.examples import parallel_strategies as ps

    n = len(devs)
    dp, sp = (2, n // 2) if n % 2 == 0 else (1, n)
    m, args = ps._gpt_case(devs, (dp, sp), ("data", "sp"), 0, 4 * dp, 16,
                           0, d_model=32, num_layers=2, num_heads=4,
                           max_len=16, seq_axis="sq")  # <- the typo
    return _lint(m, args, "axis_name_typo")


def missing_tp_g_guard(devs):
    from singa_tpu_torch.examples import parallel_strategies as ps
    from singa_tpu_torch.parallel import tp

    dp = max(1, len(devs) // 2)
    with _patched(tp, "psum_identity_bwd", lambda axis_name: (lambda a: a)):
        m, args = ps.build_scan_sharded_gpt(
            (dp, 2), ("data", "model"), dict(tp_axis="model"), devs,
            seed=12, d_model=16, num_heads=2, batch=2 * dp, seq_len=8)
        return _lint(m, args, "missing_tp_g_guard")


def doubled_zero3_gather(devs):
    from singa_tpu_torch import communicator
    from singa_tpu_torch.examples import parallel_strategies as ps
    from singa_tpu_torch.parallel import mesh as mesh_module

    orig = communicator.all_gather_tiled

    def buggy(x, axis_name, dim=0):
        full = orig(x, axis_name, dim)
        n = x.shape[dim]
        mine = full.narrow(dim, mesh_module.axis_index(axis_name) * n, n)
        return orig(mine, axis_name, dim)

    n = len(devs)
    with _patched(communicator, "all_gather_tiled", buggy):
        m, args = ps.build_scan_sharded_gpt(
            (n,), ("data",), dict(zero3_axis="data"), devs, seed=14,
            d_model=8 * n, num_heads=4, batch=2 * n, seq_len=8)
        return _lint(m, args, "doubled_zero3_gather")


def dropped_logits_gather(devs):
    """None on a rank outside the engine's (2,) mesh."""
    from singa_tpu_torch.analysis import cases
    from singa_tpu_torch.parallel import tp

    built = cases.build_case("serve_tp", devs)
    if built is None:
        return None
    eng, args = built
    with _patched(tp, "gather_cols_in_group",
                  lambda x, group, axis_name, world: x):
        return _lint(eng, args, "dropped_logits_gather")


def broken_ring_permutation(devs):
    from singa_tpu_torch.examples import parallel_strategies as ps
    from singa_tpu_torch.parallel import ring

    orig = ring._Ring.__init__

    def split(self, axis_name):
        orig(self, axis_name)
        self.next = self.prev = self.ranks[self.index ^ 1]

    n = len(devs)
    with _patched(ring._Ring, "__init__", split):
        m, args = ps.build_scan_sharded_gpt(
            (1, n), ("data", "sp"), dict(seq_axis="sp"), devs, seed=17,
            d_model=32, num_heads=4, batch=2, seq_len=4 * n)
        return _lint(m, args, "broken_ring_permutation")


def lossy_master(device="cpu"):
    """An MLP whose step re-stores its weight through bf16 after the
    update (the planted `dropped_donation`), on `device`."""
    from singa_tpu_torch import autograd, layer, model

    class LossyMaster(model.Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(4, in_features=8, device=device)

        def forward(self, x):
            return self.fc(x)

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            # the seeded bug: "save memory" by keeping W in bf16
            self.fc.W.data = self.fc.W.data.to(torch.bfloat16).float()
            return out, loss

    return LossyMaster()


def dropped_donation(devs):
    from singa_tpu_torch import opt

    torch.manual_seed(0)
    m = lossy_master()
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    y = torch.arange(4) % 4
    m.compile([x], is_train=True, use_graph=True)
    return _lint(m, (x, y), "dropped_donation")


def lint_fixture(name, devs):
    """(the rule that must flag it, the report or None off its mesh)."""
    return FIXTURES[name], globals()[name](devs)


# -- the recorder against the calls it must see ----------------------------------

#: the port's collective entry points, wrapped in the rank to count what
#: runs, by (op, phase)
_WRAPPED = (("dist", "all_reduce", "psum"),
            ("dist", "all_to_all_single", "all_to_all"),
            ("dist", "broadcast", "broadcast"),
            ("communicator", "_all_gather_into_tensor", "all_gather"),
            ("communicator", "_reduce_scatter_tensor", "reduce_scatter"))


@contextmanager
def counted_calls():
    """Count every collective the backends run (a wrapper round each
    entry point the port calls, and each P2P send of a batch), by (op,
    phase): what the recorder's `ran` records must equal."""
    import collections

    import torch.distributed as dist

    from singa_tpu_torch import communicator

    seen = collections.Counter()

    def phase():
        return ("forward" if torch._C._current_autograd_node() is None
                else "backward")

    def wrap(fn, op):
        def counted(*a, **kw):
            seen[op, phase()] += 1
            return fn(*a, **kw)
        return counted

    def batch(ops, *a, **kw):
        seen["ppermute", phase()] += sum(
            1 for o in ops if o.op is dist.isend or getattr(
                o.op, "__name__", "") == "isend")
        return orig_batch(ops, *a, **kw)

    mods = {"dist": dist, "communicator": communicator}
    saved = [(mods[m], a, getattr(mods[m], a)) for m, a, _ in _WRAPPED]
    orig_batch = dist.batch_isend_irecv
    for (mod, attr, fn), (_, _, op) in zip(saved, _WRAPPED):
        setattr(mod, attr, wrap(fn, op))
    dist.batch_isend_irecv = batch
    try:
        yield seen
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        dist.batch_isend_irecv = orig_batch


def recorded_vs_run(build, devs):
    """One recorded step of the model `build(devs)` gives, with the
    backends' calls counted: {"recorded": {(op, phase): n} of the records that
    ran, "run": the counted calls, "tp": tp.COUNTS' delta, "tp_recorded":
    {(kind, axis): n} of the tp axis's psum and gather records}."""
    import collections

    from singa_tpu_torch.analysis import trace
    from singa_tpu_torch.parallel import tp

    m, args = build(devs)
    before = collections.Counter(tp.COUNTS)
    with counted_calls() as seen, trace.CollectiveRecorder() as rec:
        m.train_one_batch(*args)
    recorded = collections.Counter(
        (r.op, r.phase) for r in rec.records if r.ran)
    tp_delta = {k: v - before.get(k, 0) for k, v in tp.COUNTS.items()
                if v - before.get(k, 0)}
    tp_rec = collections.Counter()
    for r in rec.records:
        if r.axis == "model" and r.op == "psum":
            tp_rec["g" if r.phase == "forward" else "f", "model"] += 1
        elif r.axis == "model" and r.op == "all_gather":
            tp_rec["gather", "model"] += 1
    return {"recorded": dict(recorded), "run": dict(seen), "tp": tp_delta,
            "tp_recorded": dict(tp_rec),
            "phases": sorted({r.phase for r in rec.records})}


def _distopt_mlp(devs):
    """A DistOpt(SGD) MLP over the data axis, buckets small enough that
    its gradients split into several fused all-reduces."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.examples import parallel_strategies as ps
    from singa_tpu_torch.models import MLP

    n = len(devs)
    mesh = ps._mesh((n,), ("data",), devs)
    m = MLP(16, 3, in_features=8, device=ps._dev())
    x = torch.randn(2 * n, 8, generator=ps._gen(3))
    y = torch.arange(2 * n) % 3
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1), mesh=mesh,
                                axis_name="data", buffSize=64))
    m.compile([x], is_train=True, use_graph=False)
    return m, (x, y)


# -- the rank scenario -------------------------------------------------------------


def rank_analysis(rank, world):
    """Everything tests/test_torch_analysis_ranks.py reads, from one
    spawn of `world` gloo ranks (rank 0's view; every rank lints)."""
    from singa_tpu_torch import analysis, autograd
    from singa_tpu_torch.analysis import cases
    from singa_tpu_torch.examples import parallel_strategies as ps

    devs = list(range(world))
    out = {"recorder": {}, "cases": {}, "fixtures": {}, "schedules": {}}
    builds = {name: (lambda d, n=name: ps.build_case(n, d))
              for name in ("scan_tp", "scan_seq", "scan_zero3")}
    builds["distopt_mlp"] = _distopt_mlp
    for name, build in builds.items():
        autograd.set_autocast(False)
        out["recorder"][name] = recorded_vs_run(build, devs)
    for name in PARITY_CASES + SERVE_CASES:
        autograd.set_autocast(False)
        built = cases.build_case(name, devs)
        if built is None:
            continue  # outside the serving mesh
        obj, args = built
        rep = analysis.lint_step(obj, *args, target=name)
        out["cases"][name] = {"ok": rep.ok, "summary": rep.summary(),
                              "schedule": rep.schedule}
        if name in SERVE_CASES:
            out["schedules"][name] = plain_sched(
                obj.declared_schedule(obj.mesh))
    for name in FIXTURES:
        autograd.set_autocast(False)
        rule, rep = lint_fixture(name, devs)
        if rep is not None:
            out["fixtures"][name] = {
                "rule": rule, "rules": sorted({v.rule
                                               for v in rep.violations}),
                "summary": rep.summary(), "schedule": rep.schedule}
    return out if rank == 0 else {"rank": rank}


def plain_sched(sched):
    """A declared schedule with "op@axis" keys (picklable across the two
    packages)."""
    out = {"n_blocks": sched["n_blocks"],
           "per_block": {f"{op}@{ax}": n
                         for (op, ax), n in sched["per_block"].items()}}
    if "census" in sched:
        out["census"] = {f"{op}@{ax}": n
                         for (op, ax), n in sched["census"].items()}
    return out
