"""The port stands alone and never falls back.

- singa_tpu_torch, chip_smoke.py and the port's profiling and A/B
  scripts import nothing of JAX and nothing of singa_tpu (an AST scan,
  and a real import with both blocked);
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
    ROOT / "scripts" / "ab_torch_kernels.py"]


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
        "m = singa_tpu_torch.models.gpt.GPT(vocab_size=16, d_model=32,\n"
        "    num_layers=1, num_heads=1, max_len=8, dropout=0.0,\n"
        "    scan_blocks=True, device='cpu')\n"
        "print(tuple(m(sys.modules['torch'].zeros(1, 8).long()).shape))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(1, 8, 16)"


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
