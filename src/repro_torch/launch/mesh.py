"""Device meshes over ``torch.distributed``.

Port of the JAX package's ``repro.launch.mesh``. ``jax.make_mesh`` lays a
process's devices out on a mesh; here each mesh position is one process
(rank) of an already initialised default process group, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are the
axes. Functions, not module constants: importing this module touches no
process-group or device state.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

__all__ = ["make_production_mesh", "make_mesh"]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default group, rank-major
    (rank ``r`` sits at ``numpy.unravel_index(r, shape)``).

    The default group must already be initialised and hold exactly
    ``prod(shape)`` ranks. ``device=None`` is the CUDA card (an error
    without one); ``device="cpu"`` makes a CPU mesh. The mesh's sub-groups
    take the default group's backend.
    """
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group first (torch.distributed.init_process_group)")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, the default group has {dist.get_world_size()}")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """The reference's production shapes: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)
