"""Production mesh construction: ``repro/launch/mesh.py`` over
``torch.distributed.device_mesh.init_device_mesh``.

Functions only: importing this module touches no process group. A mesh
needs an initialized default process group whose world size is the
mesh's size (``torch.distributed.init_process_group``, or ``torchrun``).
``device`` follows the device rule (None: "cuda").
"""
from __future__ import annotations

from repro_torch.device import resolve


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init(device, shape, axes)


def mesh_shape_for(n: int, model: int | None = None) -> tuple[int, int]:
    """The (data, model) shape ``make_mesh_for`` builds over n ranks."""
    model = model or _largest_pow2_leq(min(16, n))
    while n % model:
        model //= 2
    return n // model, model


def make_mesh_for(devices: int | None = None, *, model: int | None = None, device=None):
    """Elastic-scaling helper: the largest (data, model) mesh over the live
    ranks (the world size when ``devices`` is None)."""
    if devices is None:
        import torch.distributed as dist

        devices = dist.get_world_size()
    return _init(device, mesh_shape_for(devices, model), ("data", "model"))


def _init(device, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve(device).type, shape, mesh_dim_names=axes)


def _largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p
