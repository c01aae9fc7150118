"""Checkpointing with atomic commit and a background writer.

Counterpart of ``repro.checkpoint.checkpoint``, with its on-disk layout
(one directory per step, committed by an atomic rename)::

    <dir>/step_00000123.tmp/      # written here first
        manifest.json             # step, n_leaves, leaf index, extras
        arr_00000.npy ...         # one .npy per leaf
    <dir>/step_00000123/          # rename on completion = commit

A tree is nested dicts (in insertion order) and lists of tensors; its
leaves are saved in that order, and the index names each by its dotted
path (``params.blocks.0.mix.wq``, ``opt.m.period.0.mix.wq.3``) beside its
shape and dtype. bfloat16 leaves, which NumPy has no dtype for here, are
saved as their 16-bit patterns (``int16``) with ``"dtype": "bfloat16"``
in the index, and restore bit for bit. Restore copies each leaf into the
matching tensor of a tree of the same structure, in place, so a model and
its optimizer state are restored where they live. With ``shardings``
(the reference's elastic path) a leaf is instead laid out as a DTensor on
the mesh and placements given for it, whatever mesh wrote the checkpoint
(leaves are saved whole).

Restart contract (``runtime.fault_tolerance``): ``latest_step`` +
``restore_checkpoint`` resume training bit-exact, since parameters,
optimizer moments and the data pipeline's step (in ``extras``) live here.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def flatten(tree, prefix: str = ""):
    """``(dotted path, leaf)`` of every leaf of ``tree``, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the array written to disk, and the dtype to index."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, tree,
                    extras: dict | None = None) -> str:
    """Blocking save with atomic commit; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = _path(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index = []
    for i, (name, leaf) in enumerate(flatten(tree)):
        arr, dtype = _host(leaf)
        file = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, file), arr)
        index.append({"file": file, "name": name,
                      "shape": list(arr.shape), "dtype": dtype})
    manifest = {"step": step, "n_leaves": len(index), "index": index,
                "extras": extras or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic commit
    return final


def _committed(directory: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _committed(directory)
    return steps[-1] if steps else None


def map_tree(tree, fn, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(dotted path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(v, fn, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


@torch.no_grad()
def restore_checkpoint(directory: str, step: int, tree_like,
                       shardings: dict | None = None):
    """Copy the checkpoint of ``step`` into ``tree_like`` (a tree of the
    saved structure: the same leaf names and shapes), leaf by leaf in
    place; returns ``(tree, extras)``.

    ``shardings`` maps a leaf's dotted path to ``(mesh, placements)``:
    that leaf is read whole on every rank and becomes a DTensor of those
    placements on the DeviceMesh ``mesh``, in the dtype of its
    ``tree_like`` leaf, copied into it when that leaf is a DTensor too,
    else put in its place in the returned tree (``tree_like``'s
    structure)."""
    path = _path(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = list(flatten(tree_like))
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"tree expects {len(leaves)}")
    shardings = shardings or {}
    unknown = set(shardings) - {name for name, _ in leaves}
    if unknown:
        raise ValueError(f"shardings for no leaf of the tree: "
                         f"{sorted(unknown)}")
    placed = {}
    for (name, like), entry in zip(leaves, manifest["index"]):
        if name != entry["name"] or list(like.shape) != entry["shape"]:
            raise ValueError(f"checkpoint leaf {entry['name']} "
                             f"{entry['shape']} does not fit {name} "
                             f"{list(like.shape)}")
        t = torch.from_numpy(np.load(os.path.join(path, entry["file"])))
        if entry["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if name not in shardings:
            like.copy_(t)
            continue
        from torch.distributed.tensor import DTensor, distribute_tensor
        mesh, placements = shardings[name]
        dt = distribute_tensor(t.to(like.dtype), mesh, placements,
                               src_data_rank=None)
        if isinstance(like, DTensor):
            like.copy_(dt)
        else:
            placed[name] = dt
    if placed:
        tree_like = map_tree(tree_like, lambda n, leaf: placed.get(n, leaf))
    return tree_like, manifest["extras"]


class AsyncCheckpointer:
    """Background-thread saver: copy to the host at call time, serialise
    off-thread, keep the last ``keep`` steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree, extras: dict | None = None) -> None:
        self.wait()
        host = [(name, leaf.detach().to("cpu", copy=True))
                for name, leaf in flatten(tree)]
        host_tree = dict(host)   # flat, in order: the same names

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extras)
                self._gc()
            except Exception as e:      # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _committed(self.directory)[:-self.keep]:
            shutil.rmtree(_path(self.directory, s), ignore_errors=True)
