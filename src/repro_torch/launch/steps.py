"""The eager train step of the port (``repro.launch.steps``).

The reference's ``train_step`` is a jitted closure: ``value_and_grad`` of
``train_forward``, then the optimizer's update. Here
:func:`make_train_step` does the same eagerly: forward, ``backward``, then
the update in place over the model's parameter tree. The reference's
``build_cell`` (sharded jitted cells for the dry-run and multi-host runs)
waits for the sharding and cost-pass parts of the training side (ROADMAP
queue 1 items 4c / 4d).
"""

from __future__ import annotations

import torch

from repro_torch.optim import param_tree

# The 400B MoE's AdamW moments would not fit; Adafactor's factored second
# moment does (the reference's choice, kept with its name).
OPT_FOR_ARCH = {"llama4_maverick_400b": "adafactor"}
LR = 1e-4


def make_train_step(model, opt_update):
    """``train_step(opt_state, batch, step) -> (loss, grad_norm)``: the
    loss of ``batch`` (tensors on the model's device) through
    ``model.train_forward``, its gradients by ``backward``, then
    ``opt_update`` over :func:`~repro_torch.optim.param_tree` of the model
    at ``step``, parameters and ``opt_state`` updated in place. Both
    results are 0-dim tensors on the device (reading them waits for it)."""
    tree = param_tree(model)
    params = [p for parts in tree.values() for p in parts]

    def train_step(opt_state: dict, batch: dict, step: int):
        for p in params:
            p.grad = None
        loss = model.train_forward(batch)
        loss.backward()
        grads = {k: [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in parts] for k, parts in tree.items()}
        _, _, info = opt_update(grads, opt_state, tree, step)
        return loss.detach(), info["grad_norm"]

    return train_step
