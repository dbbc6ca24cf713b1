"""Device mesh construction (port of ``chambers_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
processes of the run (one device each), with named dimensions; the
parallel modules look up the process group of an axis by its name.
"""

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from chambers_tpu_torch._device import resolve_device


def create_mesh(axes: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence[int]] = None,
                device=None) -> DeviceMesh:
    """Create a named device mesh.

    :param axes: mapping axis name → size, e.g. ``{"data": 4, "model": 2}``.
        A size of ``-1`` absorbs the remaining devices. Defaults to a pure
        data-parallel mesh over all devices.
    :param devices: the global ranks to lay out (default: every rank of the
        process group, one device each).
    :param device: the device type, CUDA unless the caller asks for the CPU.

    Without a process group (a plain single process) it starts a group of
    one over an in-memory store, so that one-device meshes work anywhere.

    Example::

        mesh = create_mesh({"data": -1})              # DP over all cards
        mesh = create_mesh({"data": 2, "model": 4})   # 2-way DP x 4-way TP
    """
    device = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if devices is None:
        devices = list(range(dist.get_world_size()))
    n = len(devices)

    if axes is None:
        axes = {"data": n}
    axes = dict(axes)

    unknown = [k for k, v in axes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("At most one axis may have size -1.")
    if unknown:
        known = int(np.prod([v for v in axes.values() if v != -1]))
        if n % known:
            raise ValueError(
                f"{n} devices not divisible by fixed axes product {known}.")
        axes[unknown[0]] = n // known

    total = int(np.prod(list(axes.values())))
    if total != n:
        raise ValueError(
            f"Mesh axes {axes} require {total} devices but {n} are available.")

    ranks = torch.tensor(list(devices), dtype=torch.int64).reshape(
        tuple(axes.values()))
    return DeviceMesh(device.type, ranks, mesh_dim_names=tuple(axes))
