"""Mesh builders (counterpart of `repro/launch/mesh.py`).

The single-pod mesh is (16, 16) = 256 devices ("data", "model"); the
multi-pod mesh is (2, 16, 16) = 512 devices ("pod", "data", "model"),
"pod" a pure data-parallel axis. Both are `DeviceMesh`es built by
`init_device_mesh` over the default process group, which the caller sets
up (`torch.distributed.init_process_group` with its own store, world size
and rank); its world size must be the mesh's size. Functions, so that
importing this module touches no process group.

The roofline constants are an H100 SXM's and its node's, from NVIDIA's
data sheets."""
from __future__ import annotations

import math

import torch.distributed as dist

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {math.prod(shape)} "
            f"ranks; call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks, the process group has "
                         f"{world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with multi_pod."""
    if multi_pod:
        return _mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device_type)
    return _mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device_type)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int | None = None,
                    device_type: str = "cuda"):
    """A small ("data", "model") mesh, or ("pod", "data", "model") with
    `pod`, for tests and the chip's smoke phases."""
    if pod:
        return _mesh((pod, data, model), MULTI_POD_AXES, device_type)
    return _mesh((data, model), PRODUCTION_AXES, device_type)


# H100 SXM roofline denominators, per card, from data sheets (estimates
# for the dry run's terms, not measurements)
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # HBM3 bytes/s
NVLINK_BW = 900e9               # NVLink bytes/s (all links of one card)
# cards one NVLink domain joins: an HGX / DGX H100 node of 8
NODE_SIZE = 8
# between nodes: one ConnectX-7 NDR InfiniBand port of 400 Gb/s a card
# (NVIDIA DGX H100 data sheet: 8 such ports for 8 cards)
INTER_NODE_BW = 50e9
