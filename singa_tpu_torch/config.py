"""Run configuration (counterpart of singa_tpu/config.py): one small
dataclass of device, mesh and precision choices that trainers consume.

`device` is "auto", "cpu" or "tpu", the reference's values: "auto" and
"tpu" are the card (a reference configuration that asks for a TPU runs
on the H100), "cpu" the host. There is no fallback: "auto" raises
where no CUDA device is visible, as every entry point of the port does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["RunConfig"]


@dataclass
class RunConfig:
    """Device, mesh and precision of a training run. `precision`
    "bf16" turns on the autocast policy (fp32 master weights, bf16
    matrix-product operands with fp32 accumulation)."""

    device: str = "auto"            # "auto" | "cpu" | "tpu"
    mesh_shape: Optional[Tuple[int, ...]] = None  # None: 1-D over the group
    mesh_axes: Tuple[str, ...] = ("data",)
    precision: str = "fp32"
    seed: int = 0
    use_graph: bool = True

    def make_device(self):
        """The `device.Device` this configuration names."""
        from singa_tpu_torch import device as device_module

        if self.device == "cpu":
            return device_module.create_cpu_device()
        if self.device == "tpu":
            return device_module.create_tpu_device()
        return device_module.get_default_device()

    def make_mesh(self):
        """The process mesh of `mesh_shape` over `mesh_axes`
        (`parallel.mesh.get_mesh`)."""
        from singa_tpu_torch.parallel import mesh as mesh_module

        return mesh_module.get_mesh(self.mesh_shape, self.mesh_axes)

    def apply(self) -> None:
        """Set the process-wide switches (the seed, autocast) from this
        configuration."""
        from singa_tpu_torch import autograd, tensor

        tensor.set_seed(self.seed)
        autograd.set_autocast(self.precision == "bf16")
