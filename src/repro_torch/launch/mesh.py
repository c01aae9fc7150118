"""Production mesh builders on ``torch.distributed``: functions, so that
importing this module touches no device and starts no process group.

Counterpart of ``repro.launch.mesh``, with its axis names. Single pod:
``("data", "model")`` (16, 16), 256 chips; multi-pod adds a leading
``"pod"`` axis, (2, 16, 16), 512 chips. ``"model"`` is the bandwidth-rich
TP / EP axis, ``"data"`` carries FSDP and the batch, ``"pod"`` pure DP.
``"fabric"`` (:func:`make_fabric_mesh`) is the disaggregated-memory axis
of the sharded cold pool, one rank a home shard
(:func:`repro_torch.paging.sharded_pool.mesh_plane`); the serve CLI
builds it when a launcher starts it as that many ranks.

Each builds a ``DeviceMesh`` with ``init_device_mesh`` over the ranks of
the default process group, which the caller starts
(``torch.distributed.init_process_group`` with its address, world size
and rank); the mesh's size must be the world's. ``device_type`` is
``"cuda"`` unless the caller asks for ``"cpu"`` (gloo); the fabric mesh's
follows the default group's backend (``"cuda"`` for NCCL, else
``"cpu"``), since its ring moves tensors itself and the mesh only names
the group.
"""

from __future__ import annotations


def _init(device_type: str | None, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=names)


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init(device_type, shape, axes)


def make_fabric_mesh(n_shards: int, device_type: str | None = None):
    """1-D ``("fabric",)`` mesh over ``n_shards`` ranks, the sharded cold
    pool's home shards; raises unless the world has ``n_shards`` ranks."""
    n = _world()
    if n != n_shards:
        raise ValueError(
            f"need {n_shards} ranks for a {n_shards}-shard fabric mesh, "
            f"have {n}: start one rank a shard (torchrun "
            f"--nproc-per-node {n_shards}, or init_process_group with "
            f"world_size={n_shards})")
    if device_type is None and n > 1:
        import torch.distributed as dist
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return _init(device_type, (n_shards,), ("fabric",))


def make_host_mesh(model: int = 1, device_type: str | None = None):
    """A ``("data", "model")`` mesh over every rank of the world (tests,
    one-card runs: ``(1, 1)`` on a world of one)."""
    n = _world()
    model = min(model, n)
    return _init(device_type, (n // model, model), ("data", "model"))
