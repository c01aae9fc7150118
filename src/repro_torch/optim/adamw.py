"""AdamW with float32 moments and decoupled weight decay, over the port's
parameter tree (:func:`repro_torch.optim.common.param_tree`).

Counterpart of ``repro.optim.adamw``. Returns ``(init_fn, update_fn)``:

    state = init_fn(params)                       # m, v float32, zeros
    params, state, info = update_fn(grads, state, params, step)

``params`` is a parameter tree, ``grads`` a tree of the same keys and
lists (bf16 for a bf16 model, as the reference's), ``step`` a host int.
The update runs in place: each parameter, ``m`` and ``v`` is overwritten,
one leaf at a time, so the float32 temporaries are a few of one leaf's
size (the reference's formulas, in-place ops in their order). Gradients
are clipped to the global norm first (in place too). Weight decay skips
the leaves whose *reference* rank is 1 (``leaf_ndim``): only
``final_norm.scale`` and, for LayerNorm, ``final_norm.bias``.
"""

from __future__ import annotations

import torch

from .common import clip_by_global_norm, leaf_ndim, resolve_lr


def _scalar(x, device) -> torch.Tensor:
    """A float32 0-dim tensor on ``device``: dividing by it is a true
    division on every device (by a host scalar, CUDA multiplies by the
    reciprocal)."""
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0):
    def init_fn(params: dict) -> dict:
        zeros = lambda parts: [torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device) for p in parts]
        return {"m": {k: zeros(v) for k, v in params.items()},
                "v": {k: zeros(v) for k, v in params.items()}}

    @torch.no_grad()
    def update_fn(grads: dict, state: dict, params: dict, step: int):
        if clip_norm:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = torch.zeros((), dtype=torch.float32)
        t = torch.tensor(step, dtype=torch.float32) + 1.0
        lr_t = resolve_lr(lr, step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        scalars = {}                 # device -> (bc1, bc2, lr) on it
        for key, parts in params.items():
            decay = weight_decay and leaf_ndim(key, parts) > 1
            for p, g, m, v in zip(parts, grads[key], state["m"][key],
                                  state["v"][key]):
                if p.device not in scalars:
                    scalars[p.device] = [_scalar(x, p.device)
                                         for x in (bc1, bc2, lr_t)]
                c1, c2, lr_d = scalars[p.device]
                g = g.float()
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = torch.div(m, c1).div_(torch.sqrt(v / c2).add_(eps))
                pf = p.float()
                if decay:
                    u.add_(pf, alpha=weight_decay)
                u.mul_(lr_d)
                if pf is p:
                    p.sub_(u)
                else:
                    p.copy_(pf.sub_(u))
        return params, state, {"grad_norm": gnorm}

    return init_fn, update_fn
