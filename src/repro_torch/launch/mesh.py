"""Device meshes — PyTorch port of ``repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named axes
("data", "model"), or ("pod", "data", "model") across pods, over the ranks
of the default process group: NCCL on the card, gloo for ``device="cpu"``.
Under ``torchrun`` the group comes from the environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); a lone process gets a
group of one at ``tcp://localhost`` on a free port.  A caller that has
already initialised the group (a test's ``file://`` rendezvous) keeps it.

``make_production_mesh`` is a function, so importing this module never
touches the process group.  The single-pod mesh is 16×16 = 256 devices,
the multi-pod mesh 2×16×16 = 512.
"""
from __future__ import annotations

import math
import os
import socket

import torch
import torch.distributed as dist

from repro_torch.models.common import resolve_device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_process_group(device=None) -> torch.device:
    """The default process group for ``device`` (default: the card; under
    torchrun, the card of this rank's ``LOCAL_RANK``), created unless it
    exists; returns the device."""
    if device is None and "LOCAL_RANK" in os.environ:
        device = f"cuda:{os.environ['LOCAL_RANK']}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    device_id=dev if dev.type == "cuda" else None)
        else:
            dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                    rank=0, world_size=1,
                                    device_id=dev if dev.type == "cuda" else None)
    return dev


def make_mesh(shape, axes, device=None):
    """A mesh of ``shape`` with axis names ``axes`` over every rank of the
    process group (created for ``device`` unless it exists)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = init_process_group(device)
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks; the process group "
                           f"has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ndev = math.prod(shape)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world < ndev:
        raise RuntimeError(
            f"need {ndev} devices for mesh {shape}; found {world}. Launch "
            f"{ndev} ranks with torchrun (one per card) for this mesh.")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(shape=(1, 1), axes=("data", "model"), device=None):
    """A 1×1 mesh over this process (tests, one card)."""
    return make_mesh(shape, axes, device)
