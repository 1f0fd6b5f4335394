"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, loaded with `ctypes`; pointers
and the stream cross as `c_void_p`. Libraries land in
`build/torch_kernels/` at the repository root, named by a hash of the
sources and flags, so an edited source is rebuilt on its next use.

There is no fallback: if `nvcc` is missing or a build fails, the caller
gets a `KernelBuildError` carrying the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["KernelBuildError", "build", "load", "sources"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: where the CUDA toolkit puts nvcc when neither CUDA_HOME nor PATH names it
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused a kernel source."""


def sources() -> List[str]:
    """Names of the kernel sources (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(_DEFAULT_NVCC)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{_DEFAULT_NVCC}): the CUDA kernels are built from source on "
        "first use and need the CUDA toolkit. On a host without a card, "
        "pass device='cpu' to run the plain PyTorch versions.")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: all) that is not built yet,
    one nvcc per source, all started together; return name -> library."""
    names = sources() if names is None else list(names)
    out = {n: _target(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, cmd)
    errors = []
    for n, (proc, tmp, cmd) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib
