"""The StableHLO runtime on the card (counterpart of the compile and
execute half of singa_tpu/native/__init__.py's `PjrtRuntime`, :571-764).

The reference hands `native/hlo_core.cc`'s module text to a PJRT plugin,
which compiles it for the TPU. Here the runtime is CUDA through PyTorch:
`compile_mlir(text)` parses the text into a program of steps over its
SSA values, and running the program issues one PyTorch call a step. It
reads exactly the syntax `hlo_core.cc` emits:

- the header `module @... attributes {mhlo.num_partitions = 1 : i32,
  mhlo.num_replicas = N : i32}` and one `func.func public @main`;
- `stablehlo.constant` (a scalar: a decimal literal, or a hex one of the
  type's bit width), `broadcast_in_dim`, `transpose`, `convert` (f32
  and bf16), `add`, `subtract`, `multiply`, `divide`, `maximum`,
  `exponential`, `log`, `tanh`, `logistic`, `negate`, `compare GT ...
  FLOAT`, `select`, `dot_general` over `contracting_dims = [1] x [0]`
  at `precision = [HIGHEST, HIGHEST]` (an fp32 `torch.matmul` with TF32
  off), `reduce` with an `add` or a `maximum` body, and `return`;
- the generic forms `"stablehlo.all_reduce"` (a sum; the module computes
  its own mean), `"stablehlo.reduce_scatter"` and `"stablehlo.all_gather"`
  (dimension 0), each with `replica_groups` and an `add` region where the
  op has one.

An op or an attribute outside that vocabulary raises NotImplementedError
naming the op and its line. The runtime runs the text and nothing else:
a module whose text was edited (an `all_reduce` deleted) runs as edited.

The collectives run over the current process group (NCCL on the card,
gloo on the CPU), or the group given to `compile_mlir`: a module's
`mhlo.num_replicas` must equal the group's size (a single process with
no group is a group of one) and its `replica_groups` must cover every
rank, else it raises, naming the numbers. Each collective is issued
through `analysis.trace.record` (the op in shardlint's vocabulary:
"psum", "reduce_scatter", "all_gather"), so a recorder around a run sees
what the module ran.

On the card an `Executable` runs its first call op by op (checking each
value against the type the text declares), captures the program as one
CUDA Graph on its second call and replays it from then on, the port's
counterpart of PJRT's compiled executable (as `graph.GraphStep`
captures a training step). On the CPU every call runs op by op.

    rt = HloRuntime()                      # the card; device="cpu" here
    h = rt.compile_mlir(text)
    loss, *params = rt.run_f32_multi(h, args, out_shapes)
    rt.free_executable(h)
"""

from __future__ import annotations

import re
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["HloRuntime", "Program", "Executable", "parse_module",
           "VOCABULARY"]

#: the ops `compile_mlir` reads (stablehlo.<name>, and `return`)
VOCABULARY = ("constant", "broadcast_in_dim", "transpose", "convert", "add",
              "subtract", "multiply", "divide", "maximum", "exponential",
              "log", "tanh", "logistic", "negate", "compare", "select",
              "dot_general", "reduce", "all_reduce", "reduce_scatter",
              "all_gather", "return")

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i1": torch.bool}
_BINARY = {"add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
           "divide": torch.div, "maximum": torch.maximum}
_UNARY = {"exponential": torch.exp, "log": torch.log, "tanh": torch.tanh,
          "logistic": torch.sigmoid, "negate": torch.neg}
#: a collective's op in shardlint's record vocabulary
_RECORD_OP = {"all_reduce": "psum", "reduce_scatter": "reduce_scatter",
              "all_gather": "all_gather"}

_TY = r"tensor<(?:\d+x)*(?:f32|bf16|i1)>"
_V = r"%[\w]+"
_HEADER = re.compile(
    r"module @[\w.$-]+ attributes \{mhlo\.num_partitions = (\d+) : i32, "
    r"mhlo\.num_replicas = (\d+) : i32\} \{")
_FUNC = re.compile(r"func\.func public @main\((.*)\) -> \((.*)\) \{")
_ARG = re.compile(rf"(%arg\d+): ({_TY})")
_ASSIGN = re.compile(rf"({_V}) = (.*)", re.S)
_OPNAME = re.compile(r'"?stablehlo\.(\w+)"?')
_PATTERNS = {
    "constant": re.compile(
        r"stablehlo\.constant dense<([-+.\w]+)> : tensor<(f32|bf16)>"),
    "broadcast_in_dim": re.compile(
        rf"stablehlo\.broadcast_in_dim ({_V}), dims = \[([\d, ]*)\] : "
        rf"\(({_TY})\) -> ({_TY})"),
    "transpose": re.compile(
        rf"stablehlo\.transpose ({_V}), dims = \[([\d, ]*)\] : "
        rf"\(({_TY})\) -> ({_TY})"),
    "convert": re.compile(
        rf"stablehlo\.convert ({_V}) : \(({_TY})\) -> ({_TY})"),
    "binary": re.compile(
        rf"stablehlo\.(add|subtract|multiply|divide|maximum) ({_V}), "
        rf"({_V}) : ({_TY})"),
    "unary": re.compile(
        rf"stablehlo\.(exponential|log|tanh|logistic|negate) ({_V}) : "
        rf"({_TY})"),
    "compare": re.compile(
        rf"stablehlo\.compare GT, ({_V}), ({_V}), FLOAT : "
        rf"\(({_TY}), ({_TY})\) -> ({_TY})"),
    "select": re.compile(
        rf"stablehlo\.select ({_V}), ({_V}), ({_V}) : ({_TY}), ({_TY})"),
    "dot_general": re.compile(
        rf"stablehlo\.dot_general ({_V}), ({_V}), contracting_dims = "
        rf"\[1\] x \[0\], precision = \[HIGHEST, HIGHEST\] : "
        rf"\(({_TY}), ({_TY})\) -> ({_TY})"),
    "reduce": re.compile(
        rf"stablehlo\.reduce\(({_V}) init: ({_V})\) applies "
        rf"stablehlo\.(add|maximum) across dimensions = \[(\d+)\] : "
        rf"\(({_TY}), ({_TY})\) -> ({_TY})"),
    "all_reduce": re.compile(
        rf'"stablehlo\.all_reduce"\(({_V})\) <\{{replica_groups = '
        rf'dense<(.*?)> : tensor<\d+x\d+xi64>\}}> \(\{{(.*)\}}\) : '
        rf'\(({_TY})\) -> ({_TY})', re.S),
    "reduce_scatter": re.compile(
        rf'"stablehlo\.reduce_scatter"\(({_V})\) <\{{replica_groups = '
        rf'dense<(.*?)> : tensor<\d+x\d+xi64>, scatter_dimension = 0 : '
        rf'i64\}}> \(\{{(.*)\}}\) : \(({_TY})\) -> ({_TY})', re.S),
    "all_gather": re.compile(
        rf'"stablehlo\.all_gather"\(({_V})\) <\{{all_gather_dim = 0 : i64, '
        rf'replica_groups = dense<(.*?)> : tensor<\d+x\d+xi64>\}}> : '
        rf'\(({_TY})\) -> ({_TY})'),
}
_REGION = re.compile(
    r"\s*\^bb0\(%lhs: tensor<(\w+)>, %rhs: tensor<(\w+)>\):\s*"
    r"%s = stablehlo\.add %lhs, %rhs : tensor<(\w+)>\s*"
    r"stablehlo\.return %s : tensor<(\w+)>\s*")
_RETURN = re.compile(r"return (.*) : (.*)")


def _type(text: str) -> Tuple[Tuple[int, ...], torch.dtype]:
    """(shape, dtype) of a `tensor<AxBx...xT>` type."""
    parts = text[len("tensor<"):-1].split("x")
    return tuple(int(p) for p in parts[:-1]), _DTYPES[parts[-1]]


def _literal(lit: str, dt: str) -> float:
    """A scalar `dense<>` literal: decimal, or hex of the type's width."""
    if lit.startswith("0x"):
        bits = int(lit, 16)
        if len(lit) - 2 == 8 and dt == "f32":
            return struct.unpack("<f", struct.pack("<I", bits))[0]
        if len(lit) - 2 == 4 and dt == "bf16":
            return struct.unpack("<f", struct.pack("<I", bits << 16))[0]
        raise ValueError(f"hex literal {lit} is not {dt}'s bit width")
    return float(lit)


def _groups(body: str) -> List[List[int]]:
    return [[int(v) for v in row.split(",") if v.strip()]
            for row in re.findall(r"\[([\d,\s]*)\]", body)]


def _ints(body: str) -> List[int]:
    return [int(v) for v in body.split(",") if v.strip()]


# -- the program ---------------------------------------------------------------


class Step:
    """One op of the program: env[out] = fn(*env[ins])."""

    __slots__ = ("op", "fn", "ins", "out", "type", "line")

    def __init__(self, op, fn, ins, out, type_, line):
        self.op, self.fn, self.ins, self.out = op, fn, ins, out
        self.type, self.line = type_, line


class Program:
    """A parsed module: `arg_types` and `out_types` as (shape, dtype),
    the steps in text order, the values `results` returns and the
    replica count."""

    def __init__(self, num_replicas: int, num_partitions: int):
        self.num_replicas, self.num_partitions = num_replicas, num_partitions
        self.arg_types: List[Tuple[Tuple[int, ...], torch.dtype]] = []
        self.out_types: List[Tuple[Tuple[int, ...], torch.dtype]] = []
        self.steps: List[Step] = []
        self.results: List[int] = []
        self.n_values = 0


def _statements(text: str):
    """(line number, statement) of the module, an op with a region joined
    with the region's lines."""
    lines = text.split("\n")
    i = 0
    while i < len(lines):
        ln, start = lines[i].strip(), i + 1
        i += 1
        if ln.endswith("({"):
            body = [ln]
            while i < len(lines) and not lines[i].strip().startswith("})"):
                body.append(lines[i].strip())
                i += 1
            if i == len(lines):
                raise ValueError(f"line {start}: unterminated region")
            body.append(lines[i].strip())
            i += 1
            ln = "\n".join(body)
        if ln:
            yield start, ln


def parse_module(text: str, device: torch.device, group=None) -> Program:
    """`text` as a `Program` whose constants live on `device` and whose
    collectives run over `group` (module docstring)."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if group is None and live:
        group = dist.group.WORLD
    world = dist.get_world_size(group) if live else 1
    stmts = list(_statements(text))
    if not stmts:
        raise ValueError("empty module text")
    ln, head = stmts[0]
    m = _HEADER.fullmatch(head)
    if m is None:
        raise NotImplementedError(
            f"line {ln}: module header {head!r} is not `module @name "
            f"attributes {{mhlo.num_partitions = P : i32, mhlo.num_replicas "
            f"= N : i32}} {{`")
    prog = Program(int(m.group(2)), int(m.group(1)))
    if prog.num_partitions != 1:
        raise NotImplementedError(
            f"line {ln}: mhlo.num_partitions = {prog.num_partitions}: the "
            f"runtime runs replicas, not partitions")
    if prog.num_replicas != world:
        raise ValueError(
            f"line {ln}: the module's mhlo.num_replicas = "
            f"{prog.num_replicas} but the process group has {world} "
            f"rank(s)")
    fm = _FUNC.fullmatch(stmts[1][1]) if len(stmts) > 1 else None
    if fm is None:
        raise NotImplementedError(
            f"line {stmts[-1][0]}: expected `func.func public @main(...) -> "
            f"(...) {{`")
    names: Dict[str, int] = {}
    for k, am in enumerate(_ARG.finditer(fm.group(1))):
        if am.group(1) != f"%arg{k}":
            raise ValueError(f"line {stmts[1][0]}: argument {am.group(1)} "
                             f"out of order")
        names[am.group(1)] = k
        prog.arg_types.append(_type(am.group(2)))
    prog.out_types = [_type(t.strip()) for t in fm.group(2).split(",")
                      if t.strip()]
    n = len(prog.arg_types)

    def use(name, line):
        if name not in names:
            raise ValueError(f"line {line}: {name} is used before it is "
                             f"defined")
        return names[name]

    body = stmts[2:]
    if [s for _, s in body[-2:]] != ["}", "}"]:
        raise ValueError("the module does not close its function and "
                         "itself with `}`")
    for line, st in body[:-2]:
        rm = _RETURN.fullmatch(st)
        if rm is not None:
            prog.results = [use(v.strip(), line)
                            for v in rm.group(1).split(",")]
            declared = [_type(t.strip()) for t in rm.group(2).split(",")]
            if declared != prog.out_types:
                raise ValueError(f"line {line}: return types {declared} "
                                 f"are not the function's {prog.out_types}")
            continue
        am = _ASSIGN.fullmatch(st)
        opm = _OPNAME.match(am.group(2)) if am is not None else None
        if opm is None:
            raise NotImplementedError(f"line {line}: {st.splitlines()[0]!r}"
                                      f" is not a StableHLO op the runtime "
                                      f"reads")
        op = opm.group(1)
        key = ("binary" if op in _BINARY else "unary" if op in _UNARY
               else op)
        if key not in _PATTERNS:
            raise NotImplementedError(
                f"line {line}: stablehlo.{op} is outside the runtime's "
                f"vocabulary {VOCABULARY}")
        g = _PATTERNS[key].fullmatch(am.group(2))
        if g is None:
            raise NotImplementedError(
                f"line {line}: stablehlo.{op} with attributes or operands "
                f"the runtime does not read: {am.group(2).splitlines()[0]!r}")
        # a constant is a scalar; every other op's result type comes last
        ty = (((), _DTYPES[g.group(2)]) if key == "constant"
              else _type(g.group(g.lastindex)))
        if key == "constant":
            v = torch.tensor(_literal(g.group(1), g.group(2)), dtype=ty[1],
                             device=device)
            fn, ins = (lambda c=v: c), []
        elif key in ("broadcast_in_dim", "transpose"):
            ins, dims = [use(g.group(1), line)], _ints(g.group(2))
            fn = (_broadcast(dims, ty[0]) if key == "broadcast_in_dim"
                  else (lambda a, d=tuple(dims): a.permute(d)))
        elif key == "convert":
            ins, fn = [use(g.group(1), line)], (lambda a, dt=ty[1]: a.to(dt))
        elif key in ("binary", "unary"):
            ins = [use(v, line) for v in g.groups()[1:-1]]
            fn = {**_BINARY, **_UNARY}[g.group(1)]
        elif key == "compare":
            ins, fn = [use(g.group(1), line), use(g.group(2), line)], torch.gt
        elif key == "select":
            ins, fn = [use(g.group(i), line) for i in (1, 2, 3)], torch.where
        elif key == "dot_general":
            ins = [use(g.group(1), line), use(g.group(2), line)]
            fn = torch.matmul
        elif key == "reduce":
            ins, dim = [use(g.group(1), line), use(g.group(2), line)], \
                int(g.group(4))
            fn = ((lambda a, i, d=dim: torch.add(torch.sum(a, dim=d), i))
                  if g.group(3) == "add" else
                  (lambda a, i, d=dim: torch.maximum(torch.amax(a, dim=d),
                                                     i)))
        else:  # the collectives
            groups = _groups(g.group(2))
            if len(groups) != 1 or sorted(groups[0]) != list(range(world)):
                raise ValueError(
                    f"line {line}: {op} replica_groups {groups} do not "
                    f"cover the {world} rank(s) of the process group in "
                    f"one group")
            if key != "all_gather":
                _check_region(g.group(3), line, op)
            ins, fn = [use(g.group(1), line)], _collective(key, ty[0],
                                                           group, world)
        out = n + len(prog.steps)
        names[am.group(1)] = out
        prog.steps.append(Step(op, fn, ins, out, ty, line))
    if not prog.results:
        raise ValueError("the module returns nothing")
    prog.n_values = n + len(prog.steps)
    return prog


def _collective(op: str, shape, group, world: int) -> Callable:
    """The function of collective `op` (dimension 0, result `shape`) over
    `group` of `world` ranks, recorded for shardlint as it is issued."""
    import torch.distributed as dist

    from singa_tpu_torch.analysis import trace
    from singa_tpu_torch.communicator import (_all_gather_into_tensor,
                                              _reduce_scatter_tensor)

    def fn(a):
        a = a.contiguous()
        trace.record(_RECORD_OP[op], a, group=group)
        if world == 1:
            return a.clone()
        if op == "all_reduce":
            out = a.clone()
            dist.all_reduce(out, group=group)
        elif op == "reduce_scatter":
            out = a.new_empty(shape)
            _reduce_scatter_tensor(out, a, group=group)
        else:
            out = a.new_empty(shape)
            _all_gather_into_tensor(out, a, group=group)
        return out

    return fn


def _check_region(region: str, line: int, op: str) -> None:
    m = _REGION.fullmatch(region)
    if m is None or len(set(m.groups())) != 1:
        raise NotImplementedError(
            f"line {line}: {op}'s region is not the `add` reduction the "
            f"runtime reads")


def _broadcast(dims: Sequence[int], out_shape: Tuple[int, ...]) -> Callable:
    """broadcast_in_dim: operand dim i becomes result dim dims[i]."""
    order = sorted(range(len(dims)), key=lambda i: dims[i])
    perm = tuple(order) if order != list(range(len(dims))) else None
    mapped = sorted(dims)

    def fn(a):
        if perm is not None:
            a = a.permute(perm)
        view = [1] * len(out_shape)
        for i, d in enumerate(mapped):
            view[d] = a.shape[i]
        return a.reshape(view).expand(out_shape)

    return fn


# -- running it ----------------------------------------------------------------


class Executable:
    """A compiled module on one device (module docstring): `run(args)`
    takes tensors of the argument types on the device and returns the
    results. On the card the second call captures the program as one
    CUDA Graph over static copies of the arguments, and every later call
    copies its arguments in (skipped for an argument that is the static
    copy itself, `static_inputs`) and replays it; the results are the
    graph's own output tensors, overwritten by the next call."""

    def __init__(self, program: Program, device: torch.device):
        self.program, self.device = program, device
        self.runs = self.captures = self.replays = 0
        self.static_inputs: Optional[List[torch.Tensor]] = None
        self._graph = None
        self._outs: Optional[List[torch.Tensor]] = None
        self._stream = None

    def _check_args(self, args) -> None:
        p = self.program
        if len(args) != len(p.arg_types):
            raise ValueError(f"{len(args)} arguments for a module of "
                             f"{len(p.arg_types)}")
        for k, (a, (shape, dt)) in enumerate(zip(args, p.arg_types)):
            if tuple(a.shape) != shape or a.dtype != dt:
                raise ValueError(
                    f"argument {k}: {a.dtype} {tuple(a.shape)}, the module "
                    f"declares {dt} {shape}")

    def _interpret(self, args, check: bool) -> List[torch.Tensor]:
        env: List[Optional[torch.Tensor]] = [None] * self.program.n_values
        env[:len(args)] = args
        for s in self.program.steps:
            v = s.fn(*[env[i] for i in s.ins])
            if check and (tuple(v.shape) != s.type[0]
                          or v.dtype != s.type[1]):
                raise ValueError(
                    f"line {s.line}: stablehlo.{s.op} made {v.dtype} "
                    f"{tuple(v.shape)}, the text declares {s.type[1]} "
                    f"{s.type[0]}")
            env[s.out] = v
        return [env[i] for i in self.program.results]

    def _side(self):
        from singa_tpu_torch import graph

        if self._stream is None:
            self._stream = graph.private_stream(self, self.device)
        return self._stream

    def _on_stream(self, fn):
        side, cur = self._side(), torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        return out

    def _capture(self, args) -> None:
        from singa_tpu_torch import graph

        self.static_inputs = [a.detach().clone() for a in args]
        g = torch.cuda.CUDAGraph()
        side, cur = self._side(), torch.cuda.current_stream(self.device)
        with graph.CAPTURE_LOCK:
            side.wait_stream(cur)
            with torch.cuda.graph(g, stream=side,
                                  capture_error_mode="thread_local"):
                outs = self._interpret(self.static_inputs, False)
                # a result that is an argument is copied out on each replay
                outs = [o.clone() if any(o is a for a in self.static_inputs)
                        else o for o in outs]
            cur.wait_stream(side)
        self._outs = outs
        self._graph = g
        self.captures += 1

    def run(self, args: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        args = list(args)
        self.runs += 1
        if self.device.type != "cuda":
            self._check_args(args)
            return self._interpret(args, self.runs == 1)
        if self.runs == 1:
            self._check_args(args)
            return self._on_stream(lambda: self._interpret(args, True))
        if self._graph is None:
            self._check_args(args)
            self._capture(args)
        else:
            for dst, src in zip(self.static_inputs, args):
                if dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
        self._on_stream(self._graph.replay)
        self.replays += 1
        return self._outs


class HloRuntime:
    """`PjrtRuntime`'s compile and execute on a torch device (module
    docstring): the card unless `device` names another."""

    def __init__(self, device=None):
        from singa_tpu_torch import device as device_module

        self.device = device_module.resolve(device)
        self._exes: Dict[int, Executable] = {}
        self._next = 0

    def compile_mlir(self, text: str, group=None) -> int:
        """Parse `text` into an executable; its handle."""
        exe = Executable(parse_module(text, self.device, group), self.device)
        self._next += 1
        self._exes[self._next] = exe
        return self._next

    def executable(self, handle: int) -> Executable:
        return self._exes[handle]

    def _tensors(self, handle: int, args) -> List[torch.Tensor]:
        types = self._exes[handle].program.arg_types
        return [torch.as_tensor(np.asarray(a, np.float32)).to(
            device=self.device, dtype=dt) for a, (_, dt) in zip(args, types)]

    def run_f32_multi(self, handle: int, args, out_shapes
                      ) -> List[np.ndarray]:
        """Run on host arrays; the results as float32 arrays of
        `out_shapes`."""
        outs = self._exes[handle].run(self._tensors(handle, args))
        got = [o.detach().float().cpu().numpy() for o in outs]
        for k, (o, shape) in enumerate(zip(got, out_shapes)):
            if tuple(o.shape) != tuple(shape):
                raise ValueError(f"result {k} has shape {o.shape}, not "
                                 f"{tuple(shape)}")
        return got

    def run_f32(self, handle: int, args, out_shape) -> np.ndarray:
        return self.run_f32_multi(handle, args, [out_shape])[0]

    def free_executable(self, handle: int) -> None:
        self._exes.pop(handle, None)

    def platform(self) -> str:
        return self.device.type

    def device_kind(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def num_devices(self) -> int:
        return torch.cuda.device_count() if self.device.type == "cuda" else 1

    def memory_stats(self) -> Dict[str, int]:
        if self.device.type != "cuda":
            return {}
        s = torch.cuda.memory_stats(self.device)
        return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak",
                                               0)),
                "bytes_reserved": int(s.get("reserved_bytes.all.current",
                                            0))}
