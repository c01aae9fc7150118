"""Adafactor (factored second moment, no momentum), over the port's
parameter tree (:func:`repro_torch.optim.common.param_tree`).

Counterpart of ``repro.optim.adafactor``. A leaf whose reference rank
(``leaf_ndim``) is at least 2 keeps one row and one column accumulator
instead of a full second moment; the rest keep ``v``. The reference
computes each leaf's statistics over its whole stacked array: the row
factor's normaliser, the column accumulator of a per-layer vector (a
``[n_periods, d]`` leaf there: its column runs over the periods) and the
update's RMS clip all couple the layers a leaf stacks. So the accumulators
keep the reference's stacked shapes, and each update stacks the leaf's
parts (a float32 temporary of the leaf's size), then writes each part
back.
"""

from __future__ import annotations

import torch

from .common import clip_by_global_norm, leaf_ndim, resolve_lr, stacked


def _leaf_shape(key: str, parts: list) -> tuple:
    """The reference leaf's shape."""
    return ((len(parts),) if stacked(key) else ()) + tuple(parts[0].shape)


def _leaf(key: str, parts: list) -> torch.Tensor:
    """The reference leaf in float32: the parts stacked, or the one part."""
    return (torch.stack([p.float() for p in parts]) if stacked(key)
            else parts[0].float())


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: float = 1.0, min_dim_factored: int = 2):
    def factored(key, parts) -> bool:
        return leaf_ndim(key, parts) >= min_dim_factored

    def init_fn(params: dict) -> dict:
        def one(key, parts):
            sh, dev = _leaf_shape(key, parts), parts[0].device
            z = lambda s: torch.zeros(s, dtype=torch.float32, device=dev)
            if factored(key, parts):
                return {"row": z(sh[:-1]), "col": z(sh[:-2] + sh[-1:])}
            return {"v": z(sh)}
        return {"acc": {k: one(k, v) for k, v in params.items()}}

    @torch.no_grad()
    def update_fn(grads: dict, state: dict, params: dict, step: int):
        if clip_norm:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = torch.zeros((), dtype=torch.float32)
        t = torch.tensor(step, dtype=torch.float32) + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = resolve_lr(lr, step)
        for key, parts in params.items():
            acc = state["acc"][key]
            dev = parts[0].device
            g = _leaf(key, grads[key])
            g2 = g * g + eps
            if factored(key, parts):
                row = beta * acc["row"] + (1 - beta) * g2.mean(-1)
                col = beta * acc["col"] + (1 - beta) * g2.mean(-2)
                rfac = row / torch.clamp(row.mean(-1, keepdim=True), min=eps)
                denom = torch.sqrt(rfac[..., None] * col[..., None, :])
                u = g / torch.clamp(denom, min=1e-12)
                acc["row"].copy_(row)
                acc["col"].copy_(col)
            else:
                v = beta * acc["v"] + (1 - beta) * g2
                u = g / torch.sqrt(torch.clamp(v, min=eps))
                acc["v"].copy_(v)
            # relative step size (update clipping at RMS 1)
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms, min=1.0)
            new = _leaf(key, parts) - lr_t.to(dev) * u
            for i, p in enumerate(parts):
                p.copy_(new[i] if stacked(key) else new)
        return params, state, {"grad_norm": gnorm}

    return init_fn, update_fn
