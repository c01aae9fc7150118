"""Logical-axis -> mesh-axis sharding rules (TP + FSDP + EP + SP), resolved
onto a ``torch.distributed`` DeviceMesh as DTensor placements.

Counterpart of ``repro.distributed.sharding``, with its own copies of the
rules tables. Every parameter and state leaf carries a tuple of logical
axis names (the models' ``param_specs()``); :func:`named_sharding_for`
resolves one against a mesh to the reference's PartitionSpec parts, one a
tensor dim: ``None`` (replicated), a mesh axis, or a tuple of mesh axes
(the dim split over their product). Resolution keeps the reference's four
fallbacks, which let one rules table serve all ten configs:

* **divisibility**: a dim its mesh axes' product does not divide is
  replicated (seamless's vocab 256,206 on a 16-way model axis);
* **duplicate axes**: a mesh axis an earlier dim of the leaf took is
  dropped (expert weights ``[E, D, F]``: F would reuse 'model');
* **a list is a preference order**: the first axis the mesh has is taken
  (serving's pages, ``["fabric", "data"]``), where a tuple shards over
  the product of its axes;
* **missing axes**: an axis the mesh lacks is dropped.

:func:`placements_for` turns the parts into one placement a mesh dim:
``Shard(d)`` on every mesh dim that tensor dim ``d`` is split over, else
``Replicate()`` (a mesh dim of size 1 is ``Replicate()`` either way: the
reference's split over one device is no split, and PyTorch 2.11's view
strategy refuses to flatten dims "sharded" over size-1 mesh dims). A part of two axes, such as ``("pod", "data")``, shards
one tensor dim over both mesh dims; DTensor splits over mesh dims in the
mesh's order, major to minor, so the device at ``(pod i, data j)`` holds
block ``i * n_data + j``, as the reference's ``NamedSharding`` lays it
out. A part whose axes run against the mesh's order has no DTensor form
and raises.

A mesh here is a DeviceMesh with dim names, or anything with a ``shape``
mapping of axis -> size (the tests' fake meshes of 256 and 512 chips).
"""

from __future__ import annotations

# logical name -> mesh axis (or tuple of axes)
RULES_TRAIN = {
    "vocab": "model",
    "ff": "model",
    "expert_ff": "data",             # experts take 'model'; ff spreads FSDP-style
    "heads": "model",
    "kv_heads": "model",
    "experts": "model",
    "inner": "model",
    "embed": "data",                 # FSDP: weights' d_model dim over data
    "layers": None,
    "batch": ("pod", "data"),
    "act_seq": "model",              # SP: activation seq dim
    "kv_seq": "model",
    "kv_heads_s": None,
    "pages": "data",
}

RULES_SERVE = dict(RULES_TRAIN)
# serving: the paged cold-KV pool's page axis goes to the 'fabric' axis
# when the mesh has one, else to 'data'. A *list* is a preference order
# (exactly one axis is chosen), unlike a tuple, which shards over the
# product of its axes.
RULES_SERVE["pages"] = ["fabric", "data"]


def rules_for(mode: str, multi_pod: bool) -> dict:
    rules = dict(RULES_TRAIN if mode == "train" else RULES_SERVE)
    if not multi_pod:
        rules["batch"] = "data"
    return rules


def mesh_shape(mesh) -> dict:
    """Axis name -> size of ``mesh``, in the mesh's dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axes_size(shape: dict, axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def named_sharding_for(axes: tuple, shape: tuple, mesh, rules: dict
                       ) -> tuple:
    """One leaf's logical ``axes`` and ``shape`` -> its PartitionSpec
    parts (with the fallbacks); dims beyond ``axes`` are replicated and
    not listed, as in ``PartitionSpec``."""
    msh = mesh_shape(mesh)
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, axes):
        ax = rules.get(name) if name else None
        if isinstance(ax, list):
            ax = next((a for a in ax if a in msh), None)
        if ax is None:
            parts.append(None)
            continue
        ax_t = (ax,) if isinstance(ax, str) else tuple(ax)
        ax_t = tuple(a for a in ax_t if a not in used and a in msh)
        size = _axes_size(msh, ax_t)
        if not ax_t or size <= 1 or dim % size != 0:
            parts.append(None)
            continue
        used.update(ax_t)
        parts.append(ax_t[0] if len(ax_t) == 1 else ax_t)
    return tuple(parts)


def placements_for(parts: tuple, mesh) -> tuple:
    """PartitionSpec ``parts`` -> one DTensor placement a dim of the
    DeviceMesh ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(parts):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"part {part!r} runs against the mesh's dim "
                             f"order {tuple(names)}: DTensor splits a dim "
                             "over mesh dims in the mesh's order")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def is_spec(x) -> bool:
    """Whether ``x`` is one leaf's logical-axis tuple."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def shardings_for_tree(spec_tree, shape_tree, mesh, rules: dict):
    """``spec_tree`` of logical-axis tuples and ``shape_tree`` of tensors
    (or shapes) of the same structure (dicts and lists) -> the tree of
    their parts."""
    if is_spec(spec_tree):
        shape = getattr(shape_tree, "shape", shape_tree)
        return named_sharding_for(spec_tree, tuple(shape), mesh, rules)
    if isinstance(spec_tree, dict):
        return {k: shardings_for_tree(v, shape_tree[k], mesh, rules)
                for k, v in spec_tree.items()}
    return type(spec_tree)(shardings_for_tree(s, t, mesh, rules)
                           for s, t in zip(spec_tree, shape_tree))


def batch_shardings(batch_specs: dict, mesh, rules: dict) -> dict:
    """Parts of train / prefill batches: dim 0 batch, the rest
    replicated; ``positions3 [3, B, S]`` has its batch at dim 1."""
    def one(name, leaf):
        nd = len(getattr(leaf, "shape", leaf))
        ax = ((None, "batch", None) if name == "positions3"
              else ("batch",) + (None,) * (nd - 1))
        return named_sharding_for(ax, tuple(getattr(leaf, "shape", leaf)),
                                  mesh, rules)

    return {k: one(k, v) for k, v in batch_specs.items()}
