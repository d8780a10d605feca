"""Device meshes of the port: the counterpart of ``repro.launch.mesh``.

JAX runs one controller over a mesh of devices; ``torch.distributed`` runs
one process per rank, so a mesh here is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the reference's axis names ``("data", "model")`` (or
``("data", "kvg", "model")``, its GQA serve mesh), or over the first ranks
and the next ones for the disaggregated sides. The
process group comes from the launcher (``launch/multihost`` under
``torchrun``) or, for the one-rank mesh, from :func:`make_single_mesh`
itself. Nothing here runs at import.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device

AXES = ("data", "model")
GQA_AXES = ("data", "kvg", "model")
POD_AXES = ("pod", "data", "model")
PRODUCTION_SHAPE = (16, 16)     # the reference's production (data, model)


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_single_process_group(device_type: str):
    """A world-size-1 default process group on an in-process store (no
    port, no file), unless one exists already."""
    if not dist.is_initialized():
        dist.init_process_group(_backend(device_type), store=dist.HashStore(),
                                rank=0, world_size=1)


def make_mesh(data: int, model: int, *, device_type: Optional[str] = None):
    """The (data, model) mesh over every rank of the default process group.
    ``device_type`` defaults to ``"cuda"``, as the entry points do."""
    return _make((data, model), AXES, device_type)


def make_gqa_serve_mesh(data: int, kv_groups: int, within: int, *,
                        device_type: Optional[str] = None):
    """The GQA serve mesh ("data", "kvg", "model") over every rank of the
    default process group: the counterpart of ``make_gqa_serve_mesh``, the
    same ranks seen three ways for a GQA model whose kv heads do not divide
    a flat "model" axis. The attention's heads and the cache's kv heads go
    over "kvg", the cache length over "model", the MLP's and the
    vocabulary's splits over ("kvg", "model"), the batch over "data"
    (``launch/sharding``'s rules)."""
    return _make((data, kv_groups, within), GQA_AXES, device_type)


def _make(shape, names, device_type):
    device_type = device_type or "cuda"
    want = 1
    for n in shape:
        want *= n
    have = dist.get_world_size() if dist.is_initialized() else 1
    if want != have:
        raise ValueError(
            f"mesh {tuple(shape)} needs {want} ranks, the process group "
            f"has {have}: launch {want} processes (torchrun "
            f"--nproc-per-node {want}) or pick a shape whose product is "
            f"{have}")
    init_single_process_group(device_type)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, *,
                         device_type: Optional[str] = None):
    """The reference's production mesh over every rank of the default
    process group: ("data", "model") 16 x 16, or with ``multi_pod``
    ("pod", "data", "model") 2 x 16 x 16, the pod axis pure data-parallel
    (``launch/sharding.batch_axes``). The dry run (``launch/dryrun``)
    builds it over a fake group of 256 or 512 ranks."""
    if multi_pod:
        return _make((2,) + PRODUCTION_SHAPE, POD_AXES, device_type)
    return _make(PRODUCTION_SHAPE, AXES, device_type)


def make_single_mesh(device=None):
    """A (1, 1) ``("data", "model")`` mesh on ``device``'s type (the card
    unless ``device="cpu"``): the counterpart of ``make_cpu_mesh``. Makes a
    world-size-1 process group when there is none."""
    return make_mesh(1, 1, device_type=resolve_device(device).type)


def make_disaggregated_meshes(train_shape=(2, 2), rollout_shape=(2, 2), *,
                              device_type: Optional[str] = None):
    """Disjoint train and rollout meshes over the ranks of the default
    process group: the counterpart of ``make_disaggregated_meshes``. The
    first ``prod(train_shape)`` ranks train, the next
    ``prod(rollout_shape)`` serve rollout, each a ("data", "model") mesh.
    Every rank calls it (making a mesh's groups is collective); a rank
    outside a mesh gets the mesh with no coordinate
    (``get_coordinate()`` is None). Raises when the world is too small."""
    nt, nr = math.prod(train_shape), math.prod(rollout_shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if nt + nr > have:
        raise ValueError(
            f"disaggregated meshes need {nt}+{nr} devices, have {have} — "
            "shrink the shapes or launch more processes (torchrun "
            f"--nproc-per-node {nt + nr})")
    from torch.distributed.device_mesh import DeviceMesh
    device_type = device_type or "cuda"
    return tuple(DeviceMesh(device_type, torch.arange(lo, lo + n).reshape(
                     tuple(shape)), mesh_dim_names=AXES)
                 for lo, n, shape in ((0, nt, train_shape),
                                      (nt, nr, rollout_shape)))


def mesh_ranks(mesh) -> list:
    """The global ranks of ``mesh``, in its row-major order."""
    return mesh.mesh.flatten().tolist()


def make_disaggregated_devices(train=None, rollout=None
                               ) -> Tuple[torch.device, torch.device]:
    """The train and rollout devices of the one-process disaggregated
    trainer: the one-process form of :func:`make_disaggregated_meshes`.
    ``rollout``
    defaults to ``train``, and ``train`` to the card; a card is named with
    its index. Raises when a device is not there."""
    train_dev = _indexed(resolve_device(train))
    rollout_dev = _indexed(resolve_device(train_dev if rollout is None
                                          else rollout))
    for role, dev in (("train", train_dev), ("rollout", rollout_dev)):
        if dev.type == "cuda" and dev.index is not None \
                and dev.index >= torch.cuda.device_count():
            raise ValueError(
                f"disaggregated {role} device {dev} is not there: "
                f"{torch.cuda.device_count()} visible — pick another "
                "--rollout-device or leave it to share the train device")
    return train_dev, rollout_dev


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<the current device>``, so two names of one card
    compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards on ``mesh``: its card (the current
    CUDA device) or the host."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a plain dict of
    that form (the rules take either, so they are testable without
    ranks)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
