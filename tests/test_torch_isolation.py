"""The port stands alone and never falls back.

- singa_tpu_torch (serving/, resilience/, observability/, tensor.py,
  graph.py, the Char-RNN model and trainer, MobileNetV1 and Xception
  among it), chip_smoke.py
  and the port's profiling and A/B scripts import nothing of JAX and
  nothing of singa_tpu (an AST scan, and a real import, with both
  blocked, that serves one request, takes one graph-mode Char-RNN step,
  exports a small MLP to ONNX and imports it again, and takes one
  DistOpt step and one ZeRO-1 step (every wire option, rank 1's dropout
  draws) over a gloo group of one; MobileNetV1 and Xception each take
  a graph-mode step; the spool server's process entry runs with both
  blocked; the Device classes, RunConfig, ring and Ulysses attention
  and the long-context trainer's steps over a group of one; a ZeRO-3
  GPT with the prefetch and a MoE GPT, a step each over a group of
  one; the metric exporters and the metric-name lint; the storage
  drivers, the sharded checkpoint on both drivers, the sentinel and
  `gpt_lm`'s resume; retry, the Watchdog, SpikeDetector, a supervised
  crash heal and the babysitter's module entry; a fleet agent of one
  host through ``babysit --fleet``, which never initialises CUDA, and
  the native bucket planner; the native prefetch loader and
  `prefetch_batches`, the profiler's timers and `xla_trace`,
  `utils.virtual` and the multi-slice mesh; shardlint, its `lint_step`
  and its command line over a gloo group of one; the native training
  step: `HloGraphBuilder` over native/hlo_core.cc, `hlo_bridge`'s
  lowering, the StableHLO runtime's steps and `run_replicated`, R7 and
  `--hlo`);
- with no CUDA device, the default device raises, and device="cpu" is
  the only way onto the host;
- the kernel build raises a clear error when nvcc is absent.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from singa_tpu_torch import device
from singa_tpu_torch.models.gpt import GPT
from singa_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "singa_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_gpt.py",
    ROOT / "scripts" / "ab_torch_kernels.py",
    ROOT / "scripts" / "profile_torch_serve.py",
    ROOT / "scripts" / "trace_loss_torch.py",
    ROOT / "tests" / "helper_torch_fleet.py",
    ROOT / "tests" / "helper_torch_babysat_server.py"]


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib") or top == "singa_tpu"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_forbidden_matches_the_reference_but_not_the_port():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("jaxlib.xla_client")
    assert _forbidden("singa_tpu") and _forbidden("singa_tpu.ops")
    assert not _forbidden("singa_tpu_torch")
    assert not _forbidden("singa_tpu_torch.ops.flash_attention")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import singa_tpu_torch.models.gpt, singa_tpu_torch.ops._build\n"
        "import singa_tpu_torch.ops.flash_attention, singa_tpu_torch.opt\n"
        "import singa_tpu_torch.autograd, singa_tpu_torch.model\n"
        "import singa_tpu_torch.examples.gpt_lm\n"
        "import singa_tpu_torch.examples.cnn_cifar10\n"
        "import singa_tpu_torch.models, singa_tpu_torch.ops.max_pool\n"
        "import singa_tpu_torch.layout, singa_tpu_torch.utils.data\n"
        "import singa_tpu_torch.tensor, singa_tpu_torch.observability\n"
        "import singa_tpu_torch.serving, singa_tpu_torch.serving.engine\n"
        "import singa_tpu_torch.serving.speculative\n"
        "import singa_tpu_torch.serving.frontend\n"
        "import singa_tpu_torch.serving.sched\n"
        "import singa_tpu_torch.serving.router\n"
        "import singa_tpu_torch.resilience\n"
        "import singa_tpu_torch.resilience.counters\n"
        "import singa_tpu_torch.examples.serve_gpt\n"
        "import singa_tpu_torch.graph, singa_tpu_torch.models.char_rnn\n"
        "import singa_tpu_torch.examples.char_rnn\n"
        "m = singa_tpu_torch.models.gpt.GPT(vocab_size=16, d_model=32,\n"
        "    num_layers=1, num_heads=1, max_len=8, dropout=0.0,\n"
        "    scan_blocks=True, device='cpu')\n"
        "print(tuple(m(sys.modules['torch'].zeros(1, 8).long()).shape))\n"
        "from singa_tpu_torch.serving import Request, ServingEngine\n"
        "e = ServingEngine(m, slots=1, block_size=4, window=8)\n"
        "e.admit(Request(0, [1, 2, 3], 2))\n"
        "e.step()\n"
        "print(e.decode_compiles, e.allocator.used_blocks)\n"
        "from singa_tpu_torch import opt\n"
        "from singa_tpu_torch.models import CharRNN\n"
        "r = CharRNN(8, hidden_size=8, embed_dim=4, device='cpu')\n"
        "r.set_optimizer(opt.Adam(1e-2))\n"
        "ids = sys.modules['torch'].zeros(2, 5).long()\n"
        "r.compile([ids], is_train=True, use_graph=True)\n"
        "r.train_one_batch(ids, ids)\n"
        "print(r._train_step.captures, r.optimizer.step_counter)\n"
        "import singa_tpu_torch.examples.mlp_mnist\n"
        "from singa_tpu_torch import sonnx\n"
        "from singa_tpu_torch.models import MLP\n"
        "p = MLP(8, 3, in_features=5, device='cpu')\n"
        "x = sys.modules['torch'].ones(2, 5)\n"
        "blob = sonnx.proto.encode_model(sonnx.to_onnx(p, [x]))\n"
        "(y,) = sonnx.prepare(blob, device='cpu').run([x.numpy()])\n"
        "print(y.shape, abs(y - p.eval()(x).detach().numpy()).max())\n"
        "import singa_tpu_torch.parallel.mesh\n"
        "import singa_tpu_torch.examples.dist_imagenet\n"
        "from singa_tpu_torch import communicator, distributed\n"
        "distributed.init(device='cpu')\n"
        "d = opt.DistOpt(opt.SGD(0.1), mesh=distributed.global_mesh())\n"
        "p.set_optimizer(d)\n"
        "p.compile([x], is_train=True, use_graph=True)\n"
        "p.train_one_batch(x, sys.modules['torch'].zeros(2).long())\n"
        "print(d.world_size, d.step_counter,\n"
        "      sys.modules['torch'].distributed.get_backend())\n"
        "z = opt.DistOpt(opt.Adam(1e-2), mesh=distributed.global_mesh(),\n"
        "                shard_states=True, overlap=True, buffSize=8,\n"
        "                half_wire=True, gather_half=True)\n"
        "q = MLP(8, 3, in_features=5, device='cpu')\n"
        "q.set_optimizer(z)\n"
        "q.compile([x], is_train=True, use_graph=True)\n"
        "from singa_tpu_torch import autograd\n"
        "with autograd.rank_draws(1):\n"
        "    q.train_one_batch(x, sys.modules['torch'].zeros(2).long())\n"
        "print(z.zero1_layout()['overlap'], z.step_counter,\n"
        "      sorted(z.canonicalize_states(z.dump_states()))[0])\n"
        "distributed.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[:3] == ["(1, 8, 16)", "1 0", "1 1"]
    assert lines[3] == "(2, 3) 0.0"
    assert lines[4] == "1 1 gloo"
    assert lines[5] == "True 1 __step__"


def test_exporters_and_lint_run_with_jax_and_reference_blocked():
    """observability.export and observability.lint import and run with
    JAX and the reference blocked: the lint is clean over the port, and
    the exporters render a counter and a histogram."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from singa_tpu_torch.observability import export, lint, metrics\n"
        "reg = metrics.Registry()\n"
        "reg.counter('restores').inc(2)\n"
        "reg.histogram('serve_token_ms').observe(3.0)\n"
        "text = export.prometheus_text(reg)\n"
        "print(lint.check(), 'restores 2' in text,\n"
        "      export.json_snapshot(reg)['histograms']['serve_token_ms']\n"
        "      ['p50'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "[] True 3.0"


def test_checkpoint_and_sentinel_run_with_jax_and_reference_blocked(
        tmp_path):
    """storage/, resilience.checkpoint, faults, sentinel,
    utils.checkpoint and distributed.shard_owner_map import and run with
    JAX and the reference blocked: a guarded step skips an injected
    non-finite gradient, a save on each driver restores bitwise, and
    gpt_lm resumes from its checkpoint."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from singa_tpu_torch import distributed, opt, resilience, storage\n"
        "from singa_tpu_torch.models import MLP\n"
        "from singa_tpu_torch.resilience import GradSentinel, faults\n"
        "from singa_tpu_torch.utils import checkpoint\n"
        "from singa_tpu_torch.examples import gpt_lm\n"
        "m = MLP(8, 3, in_features=5, device='cpu')\n"
        "o = opt.Adam(1e-2)\n"
        "o.set_sentinel(GradSentinel(fault_plan=faults.nonfinite_grad_at(0)))\n"
        "m.set_optimizer(o)\n"
        "x, y = torch.ones(2, 5), torch.zeros(2).long()\n"
        "m.compile([x], is_train=True, use_graph=True)\n"
        "m.train_one_batch(x, y)\n"
        "print(m.fault_counters['nonfinite_skips'])\n"
        f"for d in ({str(tmp_path / 'ck')!r}, 'mem://iso/ck'):\n"
        "    resilience.save(d, m, o, step=1)\n"
        "    print(resilience.restore(d, m, o)['step'])\n"
        "print(distributed.shard_owner_map(torch.zeros(2, 3)))\n"
        f"a = [{str(tmp_path / 'lm')!r}, '--device', 'cpu', '--batch', '2',\n"
        "     '--seq', '16', '--d-model', '16', '--heads', '2',\n"
        "     '--sample-chars', '0', '--save-every', '1', '--steps']\n"
        "gpt_lm.main(['--checkpoint'] + a + ['1'])\n"
        "gpt_lm.main(['--checkpoint'] + a + ['2'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[:4] == ["1", "1", "1", "{((0, 2), (0, 3)): 0}"]
    assert f"resumed from {tmp_path / 'lm'} at step 1" in out.stdout


def test_self_healing_layer_runs_with_jax_and_reference_blocked(tmp_path):
    """retry, the Watchdog, SpikeDetector, the Supervisor and the
    babysitter's module entry import and run with JAX and the reference
    blocked: a supervised MLP heals a crash under a watchdog and a spike
    detector, and `python -m singa_tpu_torch.resilience.babysit` heals a
    child that fails once."""
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from singa_tpu_torch import opt, resilience\n"
        "from singa_tpu_torch.models import MLP\n"
        "from singa_tpu_torch.resilience import faults, retry\n"
        "print(retry.retry_transient('t', faults.TransientCalls(\n"
        "    lambda: 5, fail_calls=(1,)), backoff_s=0))\n"
        "x, y = torch.ones(2, 5), torch.zeros(2).long()\n"
        "def build():\n"
        "    torch.manual_seed(0)\n"
        "    m = MLP(8, 3, in_features=5, device='cpu')\n"
        "    m.set_optimizer(opt.SGD(0.1))\n"
        "    m.compile([x], is_train=True, use_graph=True)\n"
        "    return m\n"
        f"res = resilience.Supervisor(build, {str(tmp_path / 'ck')!r},\n"
        "    step_timeout_s=60, fault_hook=faults.crash_at(1),\n"
        "    spike_detector=resilience.SpikeDetector(),\n"
        "    restart_backoff_s=0).run([(x, y)] * 3)\n"
        "print(res['steps'], res['restarts'])\n"
        "sys.argv = ['babysit', '--backoff', '0', '--', sys.executable,\n"
        "            '-c', 'import os, sys; sys.exit(int(os.environ[\"'\n"
        "            'SINGA_BABYSIT_RESTARTS\"] == \"0\"))']\n"
        "try:\n"
        "    runpy.run_module('singa_tpu_torch.resilience.babysit',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('exit', e.code)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.split("\n") if not ln.startswith("#")]
    assert lines[:3] == ["5", "3 1", "exit 0"], out.stdout


def test_mobile_nets_and_tensor_run_with_jax_and_reference_blocked():
    """MobileNetV1 and Xception (narrow CIFAR shapes), the new layers and
    the tensor module import, and each net takes one graph-mode step on
    the CPU, with JAX and the reference blocked; so do the native planner
    (g++'s build of native/graph_core.cc), Xception's eval step and its
    memory estimate, and a user `autograd.Function`."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from singa_tpu_torch import layer, opt, tensor, _kernels\n"
        "from singa_tpu_torch.models import MobileNetV1, Xception\n"
        "x = torch.randn(2, 3, 16, 16)\n"
        "y = torch.tensor([1, 2])\n"
        "for m in (MobileNetV1(10, alpha=0.25, stem_stride=1,\n"
        "                      device='cpu'),\n"
        "          Xception(10, middle_reps=1, stem_stride=1,\n"
        "                   device='cpu')):\n"
        "    m.set_image_layout('NHWC')\n"
        "    m.set_optimizer(opt.SGD(0.05, momentum=0.9))\n"
        "    m.compile([x], is_train=True, use_graph=True)\n"
        "    out, loss = m(x, y)\n"
        "    print(tuple(out.shape), bool(torch.isfinite(loss)),\n"
        "          m._train_step.captures)\n"
        "print(tuple(layer.SeparableConv2d(4, 3, padding='same',\n"
        "    device='cpu')(torch.ones(1, 2, 5, 5)).shape),\n"
        "      float(tensor.sum(tensor.ones((2, 3), dev='cpu'))),\n"
        "      layer.mutation_stamp() > 0)\n"
        "from singa_tpu_torch import autograd, native\n"
        "p = native.GraphPlanner(require_native=True)\n"
        "p.add_edge(p.add_node(), p.add_node(), 0, 8)\n"
        "m.eval()\n"
        "m(x)\n"
        "autograd.training = True\n"
        "f = autograd.Function(lambda v: v * 2.0)\n"
        "g = autograd.backward(autograd.sum(f(x.requires_grad_())))\n"
        "print(p.native, p.plan_memory()[1:], m.memory_estimate is not None,\n"
        "      m._eval_step.captures, float(g[0][1].sum()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:4] == [
        "(2, 10) True 1", "(2, 10) True 1", "(1, 4, 5, 5) 6.0 True",
        "True (256, 256) True 1 3072.0"]


def test_devices_and_sequence_parallelism_run_with_jax_and_reference_blocked():
    """The Device classes, RunConfig, the N-D mesh, ring and Ulysses
    attention and the long-context trainer import and run with JAX and
    the reference blocked: the trainer's ring and Ulysses steps over a
    gloo group of one, an op counted through the exec seam."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from singa_tpu_torch import device, tensor\n"
        "from singa_tpu_torch.config import RunConfig\n"
        "from singa_tpu_torch.parallel import mesh, ring, ulysses\n"
        "from singa_tpu_torch.examples import long_context\n"
        "d = RunConfig(device='cpu').make_device()\n"
        "d.reset_op_count()\n"
        "tensor.add(tensor.ones((2,), dev=d), 1.0)\n"
        "print(type(d).__name__, d.platform, d.op_count)\n"
        "for impl in ('ring', 'ulysses'):\n"
        "    long_context.main(['--device', 'cpu', '--steps', '1',\n"
        "                       '--seq-len', '64', '--layers', '1',\n"
        "                       '--d-model', '64', '--heads', '2',\n"
        "                       '--seq-impl', impl])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[0] == "CppCPU cpu 1"
    assert "impl=ring" in out.stdout and "impl=ulysses" in out.stdout
    assert sum(line.startswith("step 0") for line in lines) == 2


def test_tensor_parallelism_runs_with_jax_and_reference_blocked():
    """parallel.tp, the pspec helpers, the tp layers and models and the
    tp serving decode import and run with JAX and the reference blocked:
    a scanned tp GPT placed on a (data 1, model 1, sp 1) mesh of a gloo
    group of one trains a step, and `serve_gpt --tp 1` serves."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from singa_tpu_torch import distributed, opt\n"
        "from singa_tpu_torch.parallel import mesh, tp\n"
        "from singa_tpu_torch.models.gpt import GPT\n"
        "from singa_tpu_torch.models.transformer import states_to_tp\n"
        "from singa_tpu_torch.examples import serve_gpt\n"
        "distributed.init(device='cpu')\n"
        "m3 = mesh.get_mesh_3d(1, 1, 1)\n"
        "g = GPT(vocab_size=16, d_model=32, num_layers=2, num_heads=2,\n"
        "        max_len=16, dropout=0.0, scan_blocks=True,\n"
        "        tp_axis='model', device='cpu')\n"
        "g.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1), mesh=m3))\n"
        "x = torch.randint(0, 16, (2, 16))\n"
        "g.compile([x], is_train=True, use_graph=True)\n"
        "loss = g.train_one_batch(x, x)[1].item()\n"
        "print(g.decoder.w_qkv.placed[1], loss > 0,\n"
        "      tp.COUNTS['g', 'model'])\n"
        "distributed.shutdown()\n"
        "serve_gpt.main(['--device', 'cpu', '--requests', '2', '--slots',\n"
        "                '2', '--max-new', '4', '--d-model', '32',\n"
        "                '--heads', '2', '--tp', '1'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    # 2 blocks x PSUMS_PER_BLOCK all-reduces in compile's forward (run
    # under the mesh's axes once the model is placed) and in the step's
    assert lines[0] == "(None, None, 'model') True 8"
    assert "served 2/2 requests" in out.stdout


def test_zero3_and_moe_run_with_jax_and_reference_blocked():
    """ZeRO-3 (`communicator.all_gather_tiled`, the prefetched stack) and
    the Switch MoE FFN (`parallel.moe`, `layer.MoEFFN`) import and run
    with JAX and the reference blocked: a scanned GPT with
    `zero3_axis="data", overlap=True` and an unrolled MoE GPT with
    `moe_axis="expert"` each train a step over a gloo group of one."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from singa_tpu_torch import distributed, layer, opt\n"
        "from singa_tpu_torch.communicator import all_gather_tiled\n"
        "from singa_tpu_torch.parallel import mesh, moe\n"
        "from singa_tpu_torch.models.gpt import GPT\n"
        "distributed.init(device='cpu')\n"
        "kw = dict(vocab_size=16, d_model=32, num_layers=2, num_heads=2,\n"
        "          max_len=16, dropout=0.0)\n"
        "x = torch.randint(0, 16, (2, 16))\n"
        "for extra, shape, names in (\n"
        "        (dict(scan_blocks=True, zero3_axis='data', overlap=True),\n"
        "         (1,), ('data',)),\n"
        "        (dict(moe_experts=2, moe_axis='expert'), (1, 1),\n"
        "         ('data', 'expert'))):\n"
        "    g = GPT(**kw, **extra, device='cpu')\n"
        "    g.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1),\n"
        "                                mesh=mesh.get_mesh(shape, names)))\n"
        "    g.compile([x], is_train=True, use_graph=True)\n"
        "    print(g.train_one_batch(x, x)[1].item() > 0)\n"
        "distributed.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["True", "True"]


def test_spool_server_entry_runs_with_jax_and_reference_blocked(tmp_path):
    """The process replica's entry (`python -m
    singa_tpu_torch.serving.router`) builds its model, serves a spool
    directory that already holds the stop marker, and exits 0 without
    importing JAX or the reference."""
    (tmp_path / "stop").write_text("")
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.argv = ['router', '--spool', {str(tmp_path)!r},\n"
        "            '--device', 'cpu']\n"
        "runpy.run_module('singa_tpu_torch.serving.router',\n"
        "                 run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "0 streams served" in out.stdout
    assert (tmp_path / "status.json").exists()


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.get_default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(vocab_size=16, d_model=32, num_layers=1, num_heads=1,
            max_len=8, dropout=0.0, scan_blocks=True)
    assert device.resolve("cpu") == torch.device("cpu")
    m = GPT(vocab_size=16, d_model=32, num_layers=1, num_heads=1,
            max_len=8, dropout=0.0, scan_blocks=True, device="cpu")
    assert m.device == torch.device("cpu")
    out = m.generate(np.array([[1, 2, 3]]), 2, window=8)
    assert out.shape == (1, 5)


def test_entry_points_pin_fp32_products():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    device.resolve("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.sources() == ["flash_bwd", "flash_fwd", "max_pool_bwd"]
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("flash_fwd")


def test_a_header_edit_renames_every_library(monkeypatch, tmp_path):
    """Every `*.cuh` is hashed into every library's name, so editing a
    shared header (attn_tiles.cuh) rebuilds all kernels that may use it."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        (csrc / f.name).write_bytes(f.read_bytes())
    assert (csrc / "attn_tiles.cuh").exists()
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._target(n) for n in _build.sources()}
    with open(csrc / "attn_tiles.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._target(n) for n in _build.sources()}
    assert all(before[n] != after[n] for n in before)


def test_pipeline_and_the_strategies_run_with_jax_and_reference_blocked():
    """parallel.pipeline, parallel.raw_steps and the strategies runner
    import and run with JAX and the reference blocked: the raw GPipe
    step and the pipelined GPT's case, two steps, over a gloo group of
    one (tests/test_torch_parallel_strategies.py runs every entry)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from singa_tpu_torch import distributed\n"
        "from singa_tpu_torch.parallel import pipeline_apply, raw_steps\n"
        "from singa_tpu_torch.examples import parallel_strategies as ps\n"
        "distributed.init(device='cpu')\n"
        "step, ops, _ = raw_steps.RAW_STEP_BUILDERS['raw_pipe'](1)\n"
        "print(tuple(step(*ops)[0].shape))\n"
        "m, args = ps.build_case('pp_transformer', [0])\n"
        "print([m.train_one_batch(*args)[1].item() > 0 for _ in 'ab'],\n"
        "      m.decoder.w_qkv.placed[1])\n"
        "distributed.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == [
        "(1, 8, 8)", "[True, True] ('pipe', None, None)"]


def test_fleet_agent_and_native_planner_run_with_jax_and_reference_blocked(
        tmp_path):
    """`babysit --fleet` at world 1 over a trainer that imports nothing:
    the agent elects itself, brokers a coordinator, runs the trainer and
    writes DONE without importing JAX or the reference and without
    initialising CUDA; the native bucket planner, the native graph
    planner's library beside it, plans with both blocked."""
    rdv = tmp_path / "rdv"
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from singa_tpu_torch import communicator, native\n"
        "from singa_tpu_torch.resilience import babysitter\n"
        "trainer = ('import os; hb = os.environ[\"SINGA_HEARTBEAT_FILE\"];'\n"
        "           ' open(hb, \"a\").close();'\n"
        "           ' print(os.environ[\"SINGA_FLEET_WORLD\"],'\n"
        "           ' os.environ[\"SINGA_COORDINATOR\"] != \"\")')\n"
        f"rc = babysitter.main(['--fleet', {str(rdv)!r}, '--fleet-rank',\n"
        "                      '0', '--fleet-world', '1', '--poll', '0.05',\n"
        "                      '--', sys.executable, '-c', trainer])\n"
        "print('rc', rc, 'cuda', torch.cuda.is_initialized())\n"
        "print(communicator.plan_buckets([3, 2, 4], 5),\n"
        "      native.native_call_count())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert "1 True" in lines, out.stdout
    assert "rc 0 cuda False" in lines, out.stdout
    assert "[[0, 1], [2]] 1" in lines, out.stdout
    assert (rdv / "DONE").exists()


def test_utils_and_loader_run_with_jax_and_reference_blocked(tmp_path):
    """The native prefetch loader (g++'s build of
    native/dataloader_core.cc), `utils.data.prefetch_batches`,
    `utils.profiler` and `utils.virtual` import and run with JAX and the
    reference blocked: a view and a copy from the loader, a StepTimer, a
    phase report, a CPU trace, `--virtual-devices 0` as a no-op and the
    one-slice mesh of a world-1 gloo group."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from singa_tpu_torch import distributed, native\n"
        "from singa_tpu_torch.utils import data, profiler, virtual\n"
        "x = np.arange(40, dtype=np.float32).reshape(10, 4)\n"
        "y = np.arange(10, dtype=np.int32)\n"
        "loader = native.NativeLoader(x, y, 4, copy=False)\n"
        "bx, by = next(loader)\n"
        "print(bx.shape, bx.flags.owndata, native.native_call_count())\n"
        "loader.close()\n"
        "print(len(list(data.prefetch_batches(x, y, 4, 5))))\n"
        "t = profiler.StepTimer()\n"
        "with t.step(sync=torch.ones(2)):\n"
        "    with profiler.phase('p'):\n"
        "        pass\n"
        f"with profiler.xla_trace({str(tmp_path)!r}) as tr:\n"
        "    torch.ones(4, 4).sum()\n"
        "print(t.summary()['steps'], profiler.phase_report()['p']['calls'],\n"
        "      tr.path.endswith('.json'))\n"
        "virtual.ensure(0, 'x')\n"
        "distributed.init(device='cpu')\n"
        "print(distributed.global_mesh(dcn_mesh_shape=(1,)).ranks)\n"
        "distributed.shutdown()\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:4] == [
        "(4, 4) False 1", "5", "1 1 True", "(0,)"]


def test_shardlint_runs_with_jax_and_reference_blocked():
    """singa_tpu_torch.analysis (the recorder, the rules, the registry,
    the command line) imports and runs with JAX and the reference
    blocked: `lint_step` on a ZeRO-3 scanned GPT over a gloo group of
    one is clean, and `python -m singa_tpu_torch.analysis --device cpu
    --case scan_zero3` prints its report."""
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from singa_tpu_torch import analysis, distributed, graph\n"
        "from singa_tpu_torch.analysis import cases, rules, trace\n"
        "distributed.init(device='cpu')\n"
        "m, args = cases.build_case('scan_zero3', [0])\n"
        "rep = analysis.lint_step(m, *args)\n"
        "print(rep.ok, rep.schedule['found'])\n"
        "distributed.shutdown()\n"
        "sys.argv = ['analysis', '--device', 'cpu', '--case', 'scan_zero3',\n"
        "            '--out', '']\n"
        "try:\n"
        "    runpy.run_module('singa_tpu_torch.analysis',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('exit', e.code)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[0] == "True {'all_gather@data': 12}"
    assert "OK   scan_zero3" in lines
    assert "[shardlint] 1/1 clean" in lines and "exit 0" in lines


def test_native_step_runs_with_jax_and_reference_blocked():
    """The native training step (g++'s build of native/hlo_core.cc, the
    tape lowering, the StableHLO runtime, `run_replicated` over a gloo
    group of one, R7 and `python -m singa_tpu_torch.analysis --hlo`)
    imports and runs with JAX and the reference blocked."""
    code = (
        "import runpy, sys\n"
        "for m in ('jax', 'jaxlib', 'singa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from singa_tpu_torch import analysis, distributed\n"
        "from singa_tpu_torch.analysis import cases\n"
        "from singa_tpu_torch.examples.parallel_strategies import "
        "native_dp_step\n"
        "from singa_tpu_torch.native import hlo_bridge\n"
        "step, batches = native_dp_step(1)\n"
        "losses = step.run_steps(batches, device='cpu')\n"
        "print(len(losses), step.text.count('stablehlo.dot_general'))\n"
        "distributed.init(device='cpu')\n"
        "rows = hlo_bridge.run_replicated(step, batches, device='cpu')\n"
        "print([r[0] for r in rows] == losses)\n"
        "rep = analysis.run_rules(cases.iter_hlo_cases(1)[0].trace([0]),\n"
        "                         rules=analysis.HLO_RULES)\n"
        "print(rep.ok, rep.hlo)\n"
        "distributed.shutdown()\n"
        "sys.argv = ['analysis', '--hlo', '--case', 'native_dp',\n"
        "            '--device', 'cpu', '--out', '']\n"
        "try:\n"
        "    runpy.run_module('singa_tpu_torch.analysis',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('exit', e.code)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split("\n")
    assert lines[:3] == ["2 6", "True",
                         "True {'census': {}, 'expected': {}}"]
    assert "OK   native_dp" in lines and "exit 0" in lines
