"""Mesh factories, as the reference's ``repro.launch.mesh``.

Functions, not module-level constants, so importing this module touches no
process group. A mesh is a ``torch.distributed`` DeviceMesh with named
dimensions over the default process group: the production meshes over the
256 or 512 ranks of a dry run's ``fake`` group (``launch/dryrun.py``), the
local one over the ranks that exist.
"""
from __future__ import annotations

import atexit
import math
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import mesh_axis_names, mesh_shape

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_info",
           "init_local_group"]


def _device_type() -> str:
    """The mesh's device type: "cuda" for an NCCL group, else "cpu" (gloo,
    and a dry run's fake group, whose DTensors hold ``meta`` tensors)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the default "
                         f"process group has {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(16,16) (data, model) single pod; (2,16,16) (pod, data, model) for 2."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def init_local_group(device=None) -> None:
    """Make the default process group when there is none.

    Under a launcher that sets ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``
    (torchrun) the group joins it (``env://``); else it is a group of one
    rank over a ``FileStore`` in a fresh temporary directory, which needs no
    network port. The backend is NCCL on the card and gloo only for
    ``device="cpu"``: nothing falls back from one to the other.
    """
    if dist.is_initialized():
        return
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError("no CUDA device with NCCL is available; pass "
                               "device='cpu' for a gloo group")
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    else:
        backend = "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend)
        return
    store_dir = tempfile.mkdtemp(prefix="repro_torch_pg_")
    atexit.register(shutil.rmtree, store_dir, ignore_errors=True)
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)


def make_local_mesh(data: int | None = None, model: int = 1, device=None):
    """(data, model) mesh over every rank of the default group (made, on
    the card, as a group of one rank when the caller made none). Raises when
    the world size is not ``data * model`` (``data`` None: a multiple of
    ``model``), as the reference's ``jax.make_mesh`` does."""
    n = (dist.get_world_size() if dist.is_initialized()
         else int(os.environ.get("WORLD_SIZE", 1)))
    if n % model or (data is not None and data * model != n):
        raise ValueError(f"{n} ranks cannot form a mesh of data={data} x "
                         f"model={model}")
    init_local_group(device)
    return _mesh((n // model if data is None else data, model),
                 ("data", "model"))


def mesh_info(mesh) -> dict:
    shape = mesh_shape(mesh)
    return {"shape": shape, "n_devices": math.prod(shape.values()),
            "axis_names": list(mesh_axis_names(mesh))}
