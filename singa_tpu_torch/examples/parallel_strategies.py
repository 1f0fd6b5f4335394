"""Every parallel strategy in one run: dp, sp, tp, ep and pp
(counterpart of examples/parallel_strategies.py and of the reference's
`__graft_entry__.run_all_strategies`).

Each entry builds a small model of the reference's case registry
(`singa_tpu/analysis/cases.py`: the same names, meshes, widths and
seeds; the port draws its own weights), trains it two steps through
`Model.compile` + `train_one_batch` over the ranks of the process
group, and prints the reference's `[dryrun] ...: ok` line; the five
hand-written steps of `parallel.raw_steps` run one step each, as the
reference's do. An entry whose mesh the world does not factor prints
the reference's skip notice. The native DP entry is the reference's
`_dryrun_native_dp`: the MLP's SGD step emitted by `native/hlo_core.cc`
as one n-replica StableHLO module (`native.hlo_bridge`), run by
`hlo_bridge.run_replicated` for 2 steps, one replica a rank, the
replicas checked bitwise identical after each. The steps run
uncaptured.

Every rank runs this module with its `--rank`; `--world` and
`--coordinator` ("host:port", or an init method such as
"file:///tmp/rdv") make the group, and a world of one (the default)
needs no address. NCCL on the card, gloo with `--device cpu`:

    python -m singa_tpu_torch.examples.parallel_strategies
    python -m singa_tpu_torch.examples.parallel_strategies --device cpu \\
        --world 4 --rank R --coordinator file:///tmp/rdv  # each R of 0-3

`--virtual-devices N` runs it as N gloo ranks, one CPU process each
(`utils.virtual`), the reference's virtual mesh:

    python -m singa_tpu_torch.examples.parallel_strategies \
        --virtual-devices 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from singa_tpu_torch import distributed as dist_mod
from singa_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                           MODEL_AXIS, PIPE_AXIS, SEQ_AXIS)
from singa_tpu_torch.utils import virtual

__all__ = ["LintCase", "iter_cases", "build_case", "build_scan_sharded_gpt",
           "build_pipe_mlp", "native_dp_step", "run_all_strategies", "run",
           "main"]


@dataclasses.dataclass
class LintCase:
    """One configuration of the reference's registry: `build(devs)`
    gives (the compiled model, its step arguments); `min_devices` and
    `divides` say which worlds its mesh factors on."""

    name: str
    build: Callable[[Sequence], Tuple]
    min_devices: int = 1
    divides: int = 1

    def applicable(self, n_devices: int) -> bool:
        return (n_devices >= self.min_devices
                and n_devices % self.divides == 0)


def _dev():
    from singa_tpu_torch import device as device_module

    return dist_mod.device() or device_module.resolve(None)


def _mesh(shape, axes, devs):
    from singa_tpu_torch.parallel import mesh as mesh_module

    return mesh_module.get_mesh(shape, axes, devices=list(devs)[
        :math.prod(shape)])


def _gen(seed: int) -> torch.Generator:
    g = torch.Generator(device=_dev())
    g.manual_seed(seed)
    return g


def _tokens(rng, vocab: int, shape) -> torch.Tensor:
    return torch.from_numpy(rng.integers(0, vocab, shape)).to(_dev())


def _finish(m, x, opt_):
    """Set the optimizer and compile for uncaptured training steps."""
    m.set_optimizer(opt_)
    m.compile([x], is_train=True, use_graph=False)
    return m


# -- the shared model constructors ---------------------------------------------


def build_scan_sharded_gpt(mesh_shape, axes, gpt_kw, devs, seed, d_model,
                           num_heads, batch, seq_len, remat="none"):
    """A sharded scanned GPT (3 blocks, vocab 64) on the given mesh,
    trained by DistOpt(SGD(0.05, momentum 0.9)) over the data axis."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.models.gpt import GPT

    mesh = _mesh(mesh_shape, axes, devs)
    v = 64
    m = GPT(vocab_size=v, d_model=d_model, num_layers=3,
            num_heads=num_heads, max_len=seq_len, dropout=0.0,
            scan_blocks=True, remat_policy=remat, device=_dev(),
            generator=_gen(seed), **gpt_kw)
    rng = np.random.default_rng(seed + 1)
    x = _tokens(rng, v, (batch, seq_len))
    y = _tokens(rng, v, (batch, seq_len))
    _finish(m, x, opt.DistOpt(opt.SGD(lr=0.05, momentum=0.9), mesh=mesh,
                              axis_name=DATA_AXIS))
    return m, (x, y)


def build_pipe_mlp(n_blocks: int, n_micro: int = 2, pipe_axis=PIPE_AXIS,
                   num_classes: int = 4, device=None, generator=None):
    """The pipeline-stack model: Linear(16), a `layer.PipelineStack` of
    `n_blocks` residual relu blocks, Linear(num_classes); its step is the
    mean cross-entropy, then the optimizer."""
    from singa_tpu_torch import autograd, layer, model

    class PipeMLP(model.Model):
        def __init__(self):
            super().__init__()
            self.inp = layer.Linear(16, device=device, generator=generator)
            self.stack = layer.PipelineStack(
                n_blocks, pipe_axis=pipe_axis, n_micro=n_micro,
                device=device, generator=generator)
            self.head = layer.Linear(num_classes, device=device,
                                     generator=generator)

        def forward(self, x):
            return self.head(self.stack(self.inp(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = autograd.softmax_cross_entropy(out, y)
            self.optimizer(loss)
            return out, loss

    return PipeMLP()


# -- the registry -----------------------------------------------------------


def _dp_resnet(mode: str, spars):
    def build(devs):
        from singa_tpu_torch import opt
        from singa_tpu_torch.models import resnet

        n = len(devs)
        mesh = _mesh((n,), (DATA_AXIS,), devs)
        m = resnet.resnet20_cifar(num_classes=10, device=_dev(),
                                  generator=_gen(0))
        batch = 2 * n
        x = torch.randn(batch, 3, 8, 8, generator=_gen(1), device=_dev())
        y = torch.arange(batch, device=_dev()) % 10
        _finish(m, x, opt.DistOpt(
            opt.SGD(lr=0.05, momentum=0.9), mesh=mesh, axis_name=DATA_AXIS,
            use_sparse=mode.startswith("sparse")))
        return m, (x, y, mode, spars)

    return build


def _dp_zero1(half_wire: bool, overlap: bool = False):
    def build(devs):
        from singa_tpu_torch import opt
        from singa_tpu_torch.models import resnet

        n = len(devs)
        mesh = _mesh((n,), (DATA_AXIS,), devs)
        m = resnet.resnet20_cifar(num_classes=10, device=_dev(),
                                  generator=_gen(0))
        batch = 2 * n
        x = torch.randn(batch, 3, 8, 8, generator=_gen(1), device=_dev())
        y = torch.arange(batch, device=_dev()) % 10
        # overlap: buckets small enough that resnet20's gradients split
        # into several reduce-scatter / all-gather buckets
        _finish(m, x, opt.DistOpt(
            opt.SGD(lr=0.05, momentum=0.9), mesh=mesh, axis_name=DATA_AXIS,
            shard_states=True, half_wire=half_wire, gather_half=half_wire,
            overlap=overlap, buffSize=2 ** 12 if overlap else 2 ** 21))
        return m, (x, y)

    return build


def _scan_tp(devs):
    n = len(devs)
    dp, mp = (2, n // 2) if n % 2 == 0 else (1, n)
    heads = max(2, mp)
    return build_scan_sharded_gpt(
        (dp, mp), (DATA_AXIS, MODEL_AXIS), dict(tp_axis=MODEL_AXIS), devs,
        seed=12, d_model=8 * heads, num_heads=heads, batch=2 * dp,
        seq_len=8)


def _scan_zero3(devs):
    n = len(devs)
    return build_scan_sharded_gpt(
        (n,), (DATA_AXIS,), dict(zero3_axis=DATA_AXIS), devs, seed=14,
        d_model=8 * n, num_heads=4, batch=2 * n, seq_len=8)


def _scan_tp_zero3(devs):
    dp = len(devs) // 2
    return build_scan_sharded_gpt(
        (dp, 2), (DATA_AXIS, MODEL_AXIS),
        dict(tp_axis=MODEL_AXIS, zero3_axis=DATA_AXIS), devs, seed=16,
        d_model=8 * dp, num_heads=4, batch=2 * dp, seq_len=8,
        remat="per_block")


def _scan_zero3_overlap(devs):
    n = len(devs)
    return build_scan_sharded_gpt(
        (n,), (DATA_AXIS,), dict(zero3_axis=DATA_AXIS, overlap=True), devs,
        seed=24, d_model=8 * n, num_heads=4, batch=2 * n, seq_len=8)


def _scan_seq(devs):
    n = len(devs)
    dp, sp = (2, n // 2) if n % 2 == 0 else (1, n)
    return build_scan_sharded_gpt(
        (dp, sp), (DATA_AXIS, SEQ_AXIS), dict(seq_axis=SEQ_AXIS), devs,
        seed=17, d_model=32, num_heads=4, batch=2 * dp, seq_len=4 * sp)


def _scan_3d(devs):
    dp = len(devs) // 4
    return build_scan_sharded_gpt(
        (dp, 2, 2), (DATA_AXIS, MODEL_AXIS, SEQ_AXIS),
        dict(tp_axis=MODEL_AXIS, zero3_axis=DATA_AXIS, seq_axis=SEQ_AXIS),
        devs, seed=18, d_model=16 * dp, num_heads=4, batch=2 * dp,
        seq_len=8)


def _scan_3d_overlap(devs):
    dp = len(devs) // 4
    return build_scan_sharded_gpt(
        (dp, 2, 2), (DATA_AXIS, MODEL_AXIS, SEQ_AXIS),
        dict(tp_axis=MODEL_AXIS, zero3_axis=DATA_AXIS, seq_axis=SEQ_AXIS,
             overlap=True), devs, seed=25, d_model=16 * dp, num_heads=4,
        batch=2 * dp, seq_len=8, remat="per_block")


def _gpt_case(devs, mesh_shape, axes, seed, batch, seq_len, data_seed,
              lr=0.05, **gpt_kw):
    """A GPT of vocab 64 on the given mesh, trained by DistOpt(SGD(lr))
    over the data axis (the sp, ep and pp entries)."""
    from singa_tpu_torch import opt
    from singa_tpu_torch.models.gpt import GPT

    mesh = _mesh(mesh_shape, axes, devs)
    m = GPT(vocab_size=64, dropout=0.0, device=_dev(),
            generator=_gen(seed), **gpt_kw)
    rng = np.random.default_rng(data_seed)
    x = _tokens(rng, 64, (batch, seq_len))
    y = _tokens(rng, 64, (batch, seq_len))
    _finish(m, x, opt.DistOpt(opt.SGD(lr=lr), mesh=mesh,
                              axis_name=DATA_AXIS))
    return m, (x, y)


def _sp_gpt(devs):
    n = len(devs)
    dp, sp = (2, n // 2) if n % 2 == 0 else (1, n)
    return _gpt_case(devs, (dp, sp), (DATA_AXIS, SEQ_AXIS), 0, 2 * dp,
                     8 * sp, 0, d_model=32, num_layers=2, num_heads=4,
                     max_len=8 * sp, seq_axis=SEQ_AXIS)


def _tp_bert(devs):
    from singa_tpu_torch import opt
    from singa_tpu_torch.models.transformer import BertForClassification

    n = len(devs)
    dp = 2 if n % 2 == 0 and n > 1 else 1
    mp = n // dp
    mesh = _mesh((dp, mp), (DATA_AXIS, MODEL_AXIS), devs)
    m = BertForClassification(
        num_classes=4, num_layers=1, d_model=4 * mp, num_heads=max(2, mp),
        vocab_size=50, max_len=8, dropout=0.0, tp_axis=MODEL_AXIS,
        device=_dev(), generator=_gen(2))
    ids = _tokens(np.random.default_rng(3), 50, (2 * dp, 8))
    y = torch.arange(2 * dp, device=_dev()) % 4
    _finish(m, ids, opt.DistOpt(opt.SGD(lr=0.1), mesh=mesh,
                                axis_name=DATA_AXIS))
    return m, (ids, y)


def _ep_gpt(devs):
    n = len(devs)
    dp, ep = (2, n // 2) if n % 2 == 0 else (1, n)
    return _gpt_case(devs, (dp, ep), (DATA_AXIS, EXPERT_AXIS), 5,
                     2 * dp * ep, 8, 6, d_model=16, num_layers=2,
                     num_heads=4, max_len=8, moe_experts=ep,
                     moe_axis=EXPERT_AXIS, moe_aux_coef=0.01)


def _pp_stack(devs):
    from singa_tpu_torch import opt

    n = len(devs)
    dp, pipe = (2, n // 2) if n % 2 == 0 else (1, n)
    mesh = _mesh((dp, pipe), (DATA_AXIS, PIPE_AXIS), devs)
    m = build_pipe_mlp(pipe, n_micro=2, device=_dev(), generator=_gen(0))
    batch = 4 * dp
    x = torch.randn(batch, 12, generator=_gen(1), device=_dev())
    y = torch.arange(batch, device=_dev()) % 4
    _finish(m, x, opt.DistOpt(opt.SGD(lr=0.05), mesh=mesh,
                              axis_name=DATA_AXIS))
    return m, (x, y)


def _pp_transformer(devs):
    n = len(devs)
    dp, pipe = (2, n // 2) if n % 2 == 0 else (1, n)
    return _gpt_case(devs, (dp, pipe), (DATA_AXIS, PIPE_AXIS), 7, 4 * dp, 8,
                     8, d_model=16, num_layers=pipe, num_heads=4, max_len=8,
                     pp_axis=PIPE_AXIS, pp_micro=2)


def _hybrid_3axis(devs):
    ep = len(devs) // 4
    return _gpt_case(devs, (2, 2, ep), (DATA_AXIS, SEQ_AXIS, EXPERT_AXIS),
                     9, 2 * 2 * ep, 16, 10, d_model=16, num_layers=2,
                     num_heads=4, max_len=32, seq_axis=SEQ_AXIS,
                     moe_experts=ep, moe_axis=EXPERT_AXIS, moe_aux_coef=0.01)


def iter_cases(n_devices: int) -> List[LintCase]:
    """The registry's model-level cases the strategies run, in the
    reference's order, those applicable on `n_devices` ranks."""
    cases = [
        LintCase("dp_plain", _dp_resnet("plain", None)),
        LintCase("dp_half", _dp_resnet("half", None)),
        LintCase("dp_sparse_topk", _dp_resnet("sparse-topk", 0.25)),
        LintCase("dp_sparse_thresh", _dp_resnet("sparse-thresh", 0.01)),
        LintCase("dp_zero1", _dp_zero1(False)),
        LintCase("dp_zero1_half", _dp_zero1(True)),
        LintCase("dp_zero1_overlap", _dp_zero1(False, overlap=True)),
        LintCase("scan_tp", _scan_tp),
        LintCase("scan_zero3", _scan_zero3),
        LintCase("scan_zero3_overlap", _scan_zero3_overlap),
        LintCase("scan_tp_zero3", _scan_tp_zero3, min_devices=4,
                 divides=2),
        LintCase("scan_seq", _scan_seq),
        LintCase("scan_3d", _scan_3d, min_devices=4, divides=4),
        LintCase("scan_3d_overlap", _scan_3d_overlap, min_devices=4,
                 divides=4),
        LintCase("sp_gpt", _sp_gpt),
        LintCase("tp_bert", _tp_bert),
        LintCase("ep_gpt", _ep_gpt),
        LintCase("pp_stack", _pp_stack),
        LintCase("pp_transformer", _pp_transformer),
        LintCase("hybrid_3axis", _hybrid_3axis, min_devices=8, divides=8),
    ]
    return [c for c in cases if c.applicable(n_devices)]


def build_case(name: str, devs):
    """Build the registry case `name` on `devs` (KeyError when the world
    does not admit it)."""
    for c in iter_cases(len(devs)):
        if c.name == name:
            return c.build(devs)
    raise KeyError(f"no case {name!r} for {len(devs)} devices")


# -- the runner ---------------------------------------------------------------


def _finite(loss) -> float:
    v = float(loss)
    if not math.isfinite(v):
        raise FloatingPointError(f"non-finite loss {v}")
    return v


def _two_steps(name: str, devs, steps: int = 2):
    """Build a case and train it `steps` times; returns (model, args,
    the losses)."""
    m, args = build_case(name, devs)
    losses = [_finite(m.train_one_batch(*args)[1]) for _ in range(steps)]
    return m, args, losses


def _memory(name: str, devs):
    from singa_tpu_torch import graph

    m, args, _ = _two_steps(name, devs)
    return m, graph.step_memory_analysis(m, *args)


def _extent(m, axis: str) -> int:
    """The extent of `axis` on the mesh of a case's DistOpt."""
    return m.optimizer.comm.mesh.axis_size(axis)


def _raw(name: str, devs) -> None:
    from singa_tpu_torch.parallel.raw_steps import RAW_STEP_BUILDERS

    step, operands, _ = RAW_STEP_BUILDERS[name](len(devs), devs)
    _finite(step(*operands)[1])


def native_dp_step(n: int, wire: str = "fp32", n_steps: int = 2,
                   params=None):
    """The reference's `_dryrun_native_dp` recipe: `MLP(24, 10)` on 12
    inputs, 2 rows a replica, 10 classes, lr 0.1, dropout inactive,
    lowered to one `n`-replica module on `wire`. Returns (the
    `NativeTrainStep`, the `n_steps` global batches as ``([x], onehot)``);
    `params` (the reference's names) replace the port's seeded draws."""
    from singa_tpu_torch import autograd
    from singa_tpu_torch.model import load_singa_tpu_params
    from singa_tpu_torch.models import MLP
    from singa_tpu_torch.native.hlo_bridge import lower_train_step

    local_b, in_dim, lr = 2, 12, 0.1
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n_steps, n * local_b, in_dim)).astype(
        np.float32)
    onehots = np.eye(10, dtype=np.float32)[
        rng.integers(0, 10, (n_steps, n * local_b))]
    m = MLP(24, 10, in_features=in_dim, device="cpu",
            generator=torch.Generator().manual_seed(3))
    if params is not None:
        load_singa_tpu_params(m, params)
    m.dropout.training = False
    x0 = torch.from_numpy(X[0][:local_b])
    with autograd.TapeRecorder():
        loss = autograd.softmax_cross_entropy(m.forward(x0),
                                              onehots[0][:local_b])
    step = lower_train_step(loss, list(m.get_params().values()), lr,
                            inputs=[x0], n_replicas=n, wire=wire)
    return step, [([X[i]], onehots[i]) for i in range(n_steps)]


def _native_dp(devs) -> None:
    from singa_tpu_torch.native.hlo_bridge import run_replicated

    step, batches = native_dp_step(len(devs))
    for row in run_replicated(step, batches, device=_dev()):
        for v in row:
            _finite(v)


def run_all_strategies(devs) -> None:
    """Every strategy on the ranks `devs`, in the reference's order
    (`__graft_entry__.run_all_strategies`), each printing its line."""
    n = len(devs)
    for mode in ("plain", "half", "sparse_topk", "sparse_thresh"):
        _, args, _ = _two_steps(f"dp_{mode}", devs)
        print(f"[dryrun] DP dist_option={args[2]}: ok")
    _two_steps("dp_zero1", devs)
    print("[dryrun] DP zero-1 (shard_states): ok")
    _two_steps("dp_zero1_half", devs)
    print("[dryrun] DP zero-1 half-wire (bf16 rs/ag): ok")
    _native_dp(devs)
    print("[dryrun] DP native C++ training step (hlo_bridge): ok")
    _two_steps("scan_tp", devs)
    print("[dryrun] scan x TP GPT (train_one_batch): ok")
    _, stats = _memory("scan_zero3", devs)
    print(f"[dryrun] DP zero-3 scan stack (per-block gather): ok "
          f"(per-shard parameter bytes {stats['parameter_bytes']})")
    if n % 2 or n < 4:
        print(f"[dryrun] scan x (TP x ZeRO-3): skipped "
              f"({n} devices do not factor dp x 2)")
    else:
        _, stats = _memory("scan_tp_zero3", devs)
        print(f"[dryrun] scan x (TP x ZeRO-3) GPT (train_one_batch, "
              f"per_block re-gather): ok (per-shard parameter bytes "
              f"{stats['parameter_bytes']})")
    _, stats = _memory("scan_seq", devs)
    print(f"[dryrun] scan x seq ring GPT (train_one_batch): ok "
          f"(per-device attention bytes {stats['attention_bytes']})")
    if n % 4:
        print(f"[dryrun] scan x (TP x ZeRO-3) x seq 3D: skipped "
              f"({n} devices do not factor dp x 2 x 2)")
    else:
        _, stats = _memory("scan_3d", devs)
        print(f"[dryrun] scan x (TP x ZeRO-3) x seq 3D GPT "
              f"(train_one_batch): ok (per-shard parameter bytes "
              f"{stats['parameter_bytes']}, per-device attention bytes "
              f"{stats['attention_bytes']})")
    _, stats = _memory("scan_zero3_overlap", devs)
    print(f"[dryrun] scan x ZeRO-3 overlap (double-buffered "
          f"prefetch): ok (gathered block bytes "
          f"{stats['gathered_block_bytes']} = 2 live blocks)")
    if n % 4:
        print(f"[dryrun] scan 3D overlap: skipped ({n} "
              f"devices do not factor dp x 2 x 2)")
    else:
        _, stats = _memory("scan_3d_overlap", devs)
        print(f"[dryrun] scan x (TP x ZeRO-3) x seq 3D overlap "
              f"(prefetch + pipelined ring, per_block re-gather): ok "
              f"(gathered block bytes {stats['gathered_block_bytes']})")
    m, _, _ = _two_steps("dp_zero1_overlap", devs)
    print(f"[dryrun] DP zero-1 overlap (bucketed reduce_scatter): ok "
          f"({len(m.optimizer._z_buckets or [])} independent buckets)")
    _raw("raw_sp", devs)
    print("[dryrun] SP ring attention: ok")
    _raw("raw_ulysses", devs)
    print("[dryrun] SP ulysses (all-to-all): ok")
    m, _, _ = _two_steps("sp_gpt", devs)
    if _extent(m, SEQ_AXIS) > 1:  # an axis of one rank reduces nothing
        assert SEQ_AXIS in m.optimizer.grad_axes
    print("[dryrun] SP model-level (train_one_batch): ok")
    _raw("raw_tp", devs)
    print("[dryrun] TP megatron mlp: ok")
    _two_steps("tp_bert", devs, steps=1)
    print("[dryrun] TP model-level: ok")
    _raw("raw_ep", devs)
    print("[dryrun] EP moe all_to_all: ok")
    m, _, _ = _two_steps("ep_gpt", devs)
    if _extent(m, EXPERT_AXIS) > 1:
        assert EXPERT_AXIS in m.optimizer.grad_axes
    print("[dryrun] EP model-level (train_one_batch): ok")
    _raw("raw_pipe", devs)
    print("[dryrun] PP gpipe ppermute: ok")
    _two_steps("pp_stack", devs)
    print("[dryrun] PP model-level (train_one_batch): ok")
    _two_steps("pp_transformer", devs)
    print("[dryrun] PP transformer GPT (train_one_batch): ok")
    if n % 8:
        print("[dryrun] 3-axis hybrid: skipped "
              f"(needs a multiple of 8 devices, have {n})")
    else:
        m, _, _ = _two_steps("hybrid_3axis", devs)
        assert {"sp", "expert"} <= set(m.optimizer.grad_axes)
        print("[dryrun] 3-axis dp x sp x ep MoE-GPT (train_one_batch): ok")


def run(devs) -> None:
    """The strategies on `devs`, then the reference's closing line."""
    run_all_strategies(devs)
    print("dp (DistOpt graph step: plain/half/sparse/ZeRO sync), "
          "sp (ring + ulysses + model-level GPT), "
          "tp (Megatron MLP + model-level BERT), "
          "ep (MoE all_to_all + model-level MoE-GPT), "
          "pp (GPipe scan + model-level transformer GPT): OK")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coordinator", default=None,
                   help="rank 0's 'host:port' (or an init method such as "
                        "file:///path); needed when --world > 1")
    p.add_argument("--world", type=int, default=0,
                   help="number of processes (0: one, no rendezvous)")
    p.add_argument("--rank", type=int, default=0,
                   help="this process's rank")
    virtual.add_cli_arg(p)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:<rank>)")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    virtual.ensure_from_args(
        args, "singa_tpu_torch.examples.parallel_strategies", argv)
    if args.coordinator and not args.world:
        raise SystemExit("--coordinator requires --world and --rank")
    if args.world or not dist_mod.is_initialized():
        dist_mod.init(args.coordinator, num_processes=args.world or 1,
                      process_id=args.rank, device=args.device)
    try:
        n = dist_mod.process_count()
        print(f"devices: {n} x {dist_mod.device().type}")
        run(list(range(n)))
    finally:
        dist_mod.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
