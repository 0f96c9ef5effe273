"""Device meshes: the port of ``repro.launch.mesh``.

The reference's meshes are ``jax.make_mesh`` over the devices JAX sees. The
port's are ``torch.distributed`` device meshes over the ranks of a process
group, dims ``("data", "model")`` or ``("pod", "data", "model")``: one rank a
card over NCCL, or a CPU process over gloo with ``device="cpu"``. Under
``torchrun`` the group is the one torchrun describes in the environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``); a process
started alone makes a one-rank group from an in-process ``HashStore``,
which touches no network.

:func:`abstract_mesh` carries only the axis sizes, so that sharding specs
can be computed with no ranks at all, as the reference's tests do with
``jax.sharding.AbstractMesh``.

Functions, never module-level state: importing this module starts no
process group.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from repro_torch import resolve_device

#: how long a collective may wait before the group gives up on it
GROUP_TIMEOUT = timedelta(seconds=600)


class AbstractMesh:
    """Axis names and sizes with no ranks behind them: ``shape`` maps each
    name to its size, as a ``DeviceMesh``'s ``mesh_dim_names`` and
    ``shape`` do together."""

    def __init__(self, sizes: Sequence[int], names: Sequence[str]):
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} names")
        self.mesh_dim_names = tuple(names)
        self.shape: Dict[str, int] = dict(zip(names, (int(s) for s in sizes)))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def abstract_mesh(sizes: Sequence[int], names: Sequence[str]
                  ) -> AbstractMesh:
    return AbstractMesh(sizes, names)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_world(device=None) -> torch.device:
    """The process group this process belongs to, started if need be ->
    this rank's device (its card, ``LOCAL_RANK`` under torchrun; or the
    CPU). Cuda unless ``device="cpu"``; it raises without a GPU, as every
    entry point does."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = dict(timeout=GROUP_TIMEOUT,
                  device_id=device if device.type == "cuda" else None)
        if not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
            kw.update(store=dist.HashStore(), rank=0, world_size=1)
        dist.init_process_group(_backend(device), **kw)
    return device


def _mesh(device: torch.device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_host_mesh(model_parallel: int = 1, *, device=None):
    """A (data, model) mesh over every rank of the group: (world //
    model_parallel, model_parallel)."""
    device = init_world(device)
    n = dist.get_world_size()
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model groups of "
                         f"{model_parallel}")
    return _mesh(device, (n // model_parallel, model_parallel),
                 ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production meshes: (data 16, model 16) on 256 ranks,
    (pod 2, data 16, model 16) on 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    device = init_world(device)
    if dist.get_world_size() != want:
        raise ValueError(f"the production mesh {shape} needs {want} ranks, "
                         f"the group has {dist.get_world_size()}")
    return _mesh(device, shape, names)
