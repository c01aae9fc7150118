"""Shared optimizer plumbing: the parameter tree, global-norm clipping,
schedule application.

Counterpart of ``repro.optim.common``. The reference's optimizers walk its
parameter pytree, in which every per-layer leaf is stacked over scan
periods (``params["period"][pos][...]`` is ``[n_periods, ...]``). The port
holds one tensor a layer, so its optimizers walk a *parameter tree* of the
same leaves: :func:`param_tree` maps each leaf of the reference's tree,
named by its path (``"embed"``, ``"final_norm.scale"``, ``"lm_head"``,
``"period.<pos>.mix.wq"``, ...), to the list of the port's tensors that
leaf stacks, in period order (one tensor for a leaf that is not
stacked). The encoder-decoder's reference stacks its layers without
periods: ``enc.<l>.<rest>`` and ``dec.<l>.<rest>`` are layer ``l`` of the
leaves ``enc.<rest>`` and ``dec.<rest>``. Every mixer's leaves (Mamba,
mLSTM, sLSTM, float32 ones included) are leaves like any other. Gradients
and the AdamW moments are trees of the same shape.

The reference decides weight decay and Adafactor's factoring by the rank
of *its* leaf, one more than a stacked part's: a per-layer norm scale or
bias is a ``[n_periods, d]`` leaf there and is decayed and factored, the
1-D ``final_norm.scale`` is not. :func:`leaf_ndim` gives that rank.
"""

from __future__ import annotations

import torch

#: the reference's leaves stacked over layers or periods start so
STACKS = ("period", "enc", "dec")


def stacked(key: str) -> bool:
    """Whether the reference stacks leaf ``key`` over scan periods (or,
    in the encoder-decoder, over layers)."""
    return key.split(".", 1)[0] in STACKS


def tree_key(name: str, P: int) -> tuple[str, int]:
    """A parameter's name -> ``(its reference leaf's path, its index in
    that leaf's stack)``; ``P`` is the config's scan period."""
    head, *rest = name.split(".")
    if head == "blocks":
        layer = int(rest[0])
        return ".".join(["period", str(layer % P), *rest[1:]]), layer // P
    if head in ("enc", "dec"):
        return ".".join([head, *rest[1:]]), int(rest[0])
    return ("lm_head" if name == "lm_head_w" else name), 0


def param_tree(model) -> dict[str, list[torch.Tensor]]:
    """The reference's leaf path -> the port's tensors it stacks, for a
    :class:`~repro_torch.models.transformer.Transformer` or an
    :class:`~repro_torch.models.encdec.EncDec`.

    ``blocks.<l>.<rest>`` is period ``l // P`` of ``period.<l % P>.<rest>``
    (``P = cfg.scan_period()``); ``enc.<l>.<rest>`` / ``dec.<l>.<rest>``
    are layer ``l`` of ``enc.<rest>`` / ``dec.<rest>``; the port's
    ``lm_head_w`` is the reference's ``lm_head``."""
    P = model.cfg.scan_period()
    tree: dict[str, list] = {}
    for name, t in model.named_parameters():
        key, idx = tree_key(name, P)
        parts = tree.setdefault(key, [])
        parts.extend([None] * (idx + 1 - len(parts)))
        parts[idx] = t
    return tree


def leaf_ndim(key: str, parts: list[torch.Tensor]) -> int:
    """Rank of the reference's leaf ``key``: a part's, plus one when the
    reference stacks it (even over one period)."""
    return parts[0].dim() + stacked(key)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of ``tree`` (a parameter
    tree's lists), in float32, as a 0-dim tensor on their device."""
    total = None
    for parts in tree.values():
        for g in parts:
            s = torch.sum(torch.square(g.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: dict, max_norm: float):
    """Scale every tensor of ``tree`` by ``min(1, max_norm / norm)`` in
    float32 and round back to its dtype, in place; returns ``(tree,
    norm)``."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        for parts in tree.values():
            for g in parts:
                g.mul_(scale)       # in float32, rounded to g's dtype
    return tree, norm


def resolve_lr(lr, step: int) -> torch.Tensor:
    """The learning rate at ``step``: the schedule's, or the constant's,
    as a float32 0-dim tensor on the CPU."""
    return lr(step) if callable(lr) else torch.tensor(lr, dtype=torch.float32)
