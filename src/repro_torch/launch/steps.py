"""The train steps of the port and their sharding (``repro.launch.steps``).

The reference's ``train_step`` is a jitted closure: ``value_and_grad`` of
``train_forward``, then the optimizer's update. Here
:func:`make_train_step` does the same eagerly: forward, ``backward``, then
the update in place over the model's parameter tree.

:func:`make_sharded_train_step` is the same step on a ``torch.distributed``
DeviceMesh, as the reference's ``build_cell`` jits a train cell with
shardings: the parameters and the optimizer state become DTensors placed
by the logical-axis rules (:func:`arch_rule_overrides` applied by the
caller, :func:`opt_state_shardings` for the state), the batch by
``batch_shardings``, and the activation hooks are installed as
``build_cell`` installs them for a train cell. Forward, backward and the
update then run on DTensors, whose sharding propagation stands in for
GSPMD's; a plain tensor the model makes (a mask, the rotary angles) is
taken as replicated (``implicit_replication``). Attention and the mLSTM
recurrence, independent over batch rows and heads, run on each rank's
shards (``distributed.activations.on_shards``), as GSPMD runs them
after the reference's head-sharding hook. Where DTensor has no working
strategy for an op of the route, that op's operand or result is
redistributed to ``Replicate()`` there, the collective GSPMD would
insert: the cross-entropy's gather of the target logits from
vocab-sharded logits (``layers._chunk_nll``: DTensor's masked partial is
mis-reduced by the select after it, so the gathered ``[B, C, 1]`` is
all-reduced at once), and the token ids of the embedding lookup
(``Transformer.embed_tokens``: PyTorch 2.11 has no strategy for its
backward over batch-sharded ids). Each block's branch output passes the
matmul-input hook too, so that the residual's sequence-sharded gradient
reaches the branch's weight products gathered on the sequence (2.11
cannot flatten ``[B, S]`` sharded on both). The parameters are never
gathered whole up front. ``build_cell`` itself waits
for the input-shape specs of the cost passes (ROADMAP queue 1 item 4d).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import configs as cfglib
from repro_torch.distributed import activations as acts
from repro_torch.distributed.sharding import (batch_shardings,
                                              named_sharding_for,
                                              placements_for,
                                              shardings_for_tree)
from repro_torch.optim import param_tree
from repro_torch.optim.common import stacked, tree_key

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


def arch_rule_overrides(arch: str, mode: str, multi_pod: bool) -> dict:
    """Per-arch deviations from the default TP + FSDP rules, the
    reference's: xlstm-350m trains pure-DP (no useful TP targets in its
    64-wide head blocks, a heavy per-sequence recurrent state), its batch
    over data and model (and pod), activations unsharded on the
    sequence."""
    if cfglib.canonical(arch) == "xlstm_350m" and mode == "train":
        bax = ("pod", "data", "model") if multi_pod else ("data", "model")
        return {"batch": bax, "act_seq": None}
    return {}


def tree_specs(model) -> tuple[dict, dict]:
    """``(specs, shapes)``: each leaf of the reference's parameter tree
    (``param_tree``'s keys) -> its logical axes (a stacked leaf's led by
    ``"layers"``) and its shape."""
    P = model.cfg.scan_period()
    axes = model.param_specs()
    names = {tree_key(n, P)[0]: n for n in axes}
    specs, shapes = {}, {}
    for key, parts in param_tree(model).items():
        lead = ("layers",) if stacked(key) else ()
        specs[key] = lead + axes[names[key]]
        shapes[key] = ((len(parts),) if lead else ()) + tuple(parts[0].shape)
    return specs, shapes


def opt_state_shardings(opt_name: str, pspecs: dict, pshapes: dict, mesh,
                        rules: dict) -> dict:
    """The optimizer state's parts, the reference's: AdamW's ``m`` and
    ``v`` as the parameters; Adafactor's ``row`` drops a leaf's last dim,
    ``col`` its second-to-last, ``v`` (a leaf of rank < 2) as the
    parameter. ``pspecs`` / ``pshapes`` map the reference's leaf paths to
    axes and shapes (:func:`tree_specs`)."""
    if opt_name == "adamw":
        m = shardings_for_tree(pspecs, pshapes, mesh, rules)
        return {"m": m, "v": dict(m)}

    def one(ax, shape):
        ax = tuple(ax) + (None,) * (len(shape) - len(ax))
        if len(shape) >= 2:
            return {"row": named_sharding_for(ax[:-1], shape[:-1], mesh,
                                              rules),
                    "col": named_sharding_for(ax[:-2] + ax[-1:],
                                              shape[:-2] + shape[-1:],
                                              mesh, rules)}
        return {"v": named_sharding_for(ax, shape, mesh, rules)}

    return {"acc": {k: one(ax, tuple(pshapes[k]))
                    for k, ax in pspecs.items()}}


def _dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _place(t: torch.Tensor, mesh, parts: tuple):
    """``t`` as a DTensor of ``parts`` on ``mesh`` (from rank 0's
    values)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.detach(), mesh, placements_for(parts, mesh))


def place_params(model, mesh, rules: dict) -> None:
    """Replace every parameter of ``model`` by a DTensor placed by its
    ``param_specs()`` under ``rules``, in place."""
    specs = model.param_specs()
    for name, p in list(model.named_parameters()):
        parts = named_sharding_for(specs[name], tuple(p.shape), mesh, rules)
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = nn.Parameter(_place(p, mesh, parts),
                                             requires_grad=p.requires_grad)


def place_opt_state(opt_state: dict, model, mesh, rules: dict) -> dict:
    """Place the leaves of ``opt_state`` (AdamW's or Adafactor's over the
    model's parameter tree) that are not DTensors yet, in place, by
    :func:`opt_state_shardings`; AdamW's per-layer parts drop their
    stacked leaf's leading ``"layers"`` part."""
    pspecs, pshapes = tree_specs(model)
    name = "adafactor" if "acc" in opt_state else "adamw"
    osh = opt_state_shardings(name, pspecs, pshapes, mesh, rules)
    if name == "adamw":
        for n in ("m", "v"):
            for key, parts in opt_state[n].items():
                sh = osh[n][key][1:] if stacked(key) else osh[n][key]
                for i, t in enumerate(parts):
                    if not _dtensor(t):
                        parts[i] = _place(t, mesh, sh)
    else:
        for key, acc in opt_state["acc"].items():
            for n, t in acc.items():
                if not _dtensor(t):
                    acc[n] = _place(t, mesh, osh["acc"][key][n])
    return opt_state


def install_train_hooks(mesh, rules: dict) -> None:
    """The activation hooks of a train cell, as the reference's
    ``build_cell`` installs them: the residual stream ``[batch -> batch
    axes, seq -> act_seq, d replicated]``; q / k / v head-sharded over
    'model' and gathered on the sequence; a block's normed input gathered
    on the sequence and sharded on the batch; no decode-logits hook."""
    bax = rules["batch"]
    acts.set_activation_sharding(mesh, placements_for(
        (bax, rules.get("act_seq", "model"), None), mesh))

    def redistribute(x, axes, extra):
        parts = named_sharding_for(axes, tuple(x.shape), mesh,
                                   {**rules, **extra})
        return x.redistribute(mesh, placements_for(parts, mesh))

    def attn_reshard(q, k, v):
        q = redistribute(q, ("batch", None, "heads_dim", None),
                         {"heads_dim": "model"})
        kv = ("batch", None, "kv_heads_dim", None)
        return (q, redistribute(k, kv, {"kv_heads_dim": "model"}),
                redistribute(v, kv, {"kv_heads_dim": "model"}))

    acts.set_attn_sharding(attn_reshard)
    acts.set_matmul_input_sharding(
        lambda y: redistribute(y, ("batch", None, None), {}))
    acts.set_decode_logits_sharding(None)


def make_sharded_train_step(model, opt_update, mesh, rules: dict):
    """:func:`make_train_step` on the DeviceMesh ``mesh`` under ``rules``:
    the model's parameters are placed now (:func:`place_params`), the
    optimizer state at the step's first sight of it
    (:func:`place_opt_state`), each batch by ``batch_shardings``. The
    step returns ``(loss, grad_norm)``, replicated 0-dim tensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    place_params(model, mesh, rules)
    tree = param_tree(model)
    params = [p for parts in tree.values() for p in parts]

    def train_step(opt_state: dict, batch: dict, step: int):
        place_opt_state(opt_state, model, mesh, rules)
        bsh = batch_shardings(batch, mesh, rules)
        batch = {k: _place(v.to(model.device), mesh, bsh[k])
                 for k, v in batch.items()}
        for p in params:
            p.grad = None
        install_train_hooks(mesh, rules)
        try:
            with implicit_replication():
                loss = model.train_forward(batch)
                loss.backward()
                grads = {k: [torch.zeros_like(p) if p.grad is None
                             else p.grad for p in parts]
                         for k, parts in tree.items()}
                _, _, info = opt_update(grads, opt_state, tree, step)
        finally:
            acts.clear_hooks()
        full = lambda t: t.full_tensor() if _dtensor(t) else t
        return full(loss.detach()), full(info["grad_norm"])

    return train_step
