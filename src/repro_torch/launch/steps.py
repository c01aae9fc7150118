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
taken as replicated (``implicit_replication``). Attention, independent
over batch rows and heads, and the recurrences (the mLSTM's over rows
and heads; the sLSTM's and the Mamba train scan's over rows, the
parameters they read whole on every rank, their gradients summed over
the ranks) run on each rank's shards
(``distributed.activations.on_shards``), as GSPMD runs them after the
reference's head-sharding hook; the MoE experts' products are batched
products DTensor places. Where DTensor has no working
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
gathered whole up front.

:func:`build_cell` assembles one (arch x input shape x mesh) cell of the
dry run (``launch.dryrun``), as the reference's does: the step, its
inputs (``meta`` tensors from ``configs.input_specs``, where the
reference's are ``ShapeDtypeStruct``s) and the PartitionSpec parts of
every input, from the logical-axis rules. The train cell is
:func:`make_sharded_train_step` (AdamW, Adafactor for the 400B MoE); the
prefill cell :func:`make_sharded_prefill`, ``model.prefill`` over the
whole context; the decode cell
one ``decode_step`` and the ``argmax`` of its logits against a state of
the shape's context, placed by the model's ``decode_state_specs``. A
cell's ``step_fn(*args)`` places its inputs by those parts first, as a
jitted step takes its ``in_shardings``, installs the reference's hooks
for the cell's kind (the residual's sequence sharding, H1's attention
reshard and H4's matmul-input gather for train and prefill; H5's
decode-logits sequence shards for decode; the decode state's placement
for both serve kinds), and runs on a DeviceMesh; the parts alone need
only the mesh's axis sizes. The port's ``prefill`` calls none of the
activation hooks (the reference's runs its train block): its layout is
DTensor's propagation from the placed weights and batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from repro_torch import configs as cfglib
from repro_torch.distributed import activations as acts
from repro_torch.distributed.sharding import (batch_shardings,
                                              mesh_shape, named_sharding_for,
                                              placements_for, rules_for,
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


@dataclasses.dataclass
class Cell:
    """One dry-run cell: ``step_fn(*args)`` runs the step once (on a
    DeviceMesh), ``shardings`` holds the PartitionSpec parts of its
    inputs, ``model`` the model built on ``meta``."""
    arch: str
    shape: str
    cfg: Any
    kind: str                      # train | prefill | decode
    step_fn: Callable | None
    args: tuple                    # meta tensors (unplaced)
    skip: str | None = None
    shardings: dict | None = None
    model: Any = None


def batch_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else "data"


def state_shapes_batch_divisible(state, specs, mesh, bax) -> bool:
    """Whether the batch axes ``bax`` divide the decode state's batch (the
    ``"batch"`` dim of its first leaf of two dims or more, by its logical
    axes ``specs``), as the reference decides the token's placement."""
    shape = mesh_shape(mesh)
    n = 1
    for a in ((bax,) if isinstance(bax, str) else bax):
        n *= shape[a]
    big = [(owner[k], ax) for owner, k, ax in _leaves(state, specs)
           if owner[k].dim() >= 2]
    b = big[0][0].shape[big[0][1].index("batch")] if big else 1
    return b % n == 0


def _leaves(tree: dict, parts: dict):
    """``(owner, key, part)`` of each tensor ``owner[key]`` of a decode
    state and its entry of a tree of the same structure (its parts, or its
    logical axes); ``pos`` apart."""
    for k, v in tree.items():
        if k == "pos":
            continue
        if isinstance(v, torch.Tensor):
            yield tree, k, parts[k]
        elif isinstance(v, dict):
            yield from _leaves(v, parts[k])
        else:
            for i, blk in enumerate(v):
                yield from _leaves(blk, parts[k][i])


def state_parts(specs: dict, state: dict, mesh, rules: dict) -> dict:
    """The parts of a decode state's leaves from their logical axes
    ``specs`` (a model's ``decode_state_specs()``); ``pos``, a host int,
    is ``()``."""
    body = lambda t: {k: v for k, v in t.items() if k != "pos"}
    return dict(shardings_for_tree(body(specs), body(state), mesh, rules),
                pos=())


def place_tree(tree: dict, parts: dict, mesh) -> dict:
    """The tensors of the decode state ``tree`` replaced by DTensors of
    their ``parts`` on ``mesh``, in place."""
    for owner, k, pt in _leaves(tree, parts):
        if not _dtensor(owner[k]):
            owner[k] = _place(owner[k], mesh, pt)
    return tree


def install_cell_hooks(mesh, rules: dict, kind: str) -> None:
    """The reference's ``build_cell`` hooks for a cell of ``kind``:
    :func:`install_train_hooks`'s for train and prefill (no decode-logits
    hook); for decode only H5, the logits ``[B, Hkv, G, T]`` kept sharded
    on ``T`` over ``kv_seq``'s axis. For the serve kinds also the
    placement of a new decode state's leaves by their logical axes."""
    if kind in ("train", "prefill"):
        install_train_hooks(mesh, rules)
    else:
        acts.clear_hooks()

        def logits_tsh(s):
            parts = named_sharding_for(("batch", None, None, "kv_seq"),
                                       tuple(s.shape), mesh, rules)
            return s.redistribute(mesh, placements_for(parts, mesh))

        acts.set_decode_logits_sharding(logits_tsh)
    if kind != "train":
        acts.set_decode_state_sharding(
            lambda st, specs: place_tree(
                st, state_parts(specs, st, mesh, rules), mesh))


def make_sharded_prefill(model, mesh, rules: dict):
    """``prefill(batch, max_len) -> (logits, state)``: ``model.prefill`` on
    the DeviceMesh ``mesh`` under the serve ``rules``, as the dry run's
    prefill cell runs it. The parameters are placed at the first call
    (:func:`place_params`), each batch (``tokens``, and ``frames``,
    ``positions3`` or ``embeds`` where the model takes them, on the
    model's device) by ``batch_shardings``, under the prefill cell's hooks
    (:func:`install_cell_hooks`); the logits and the decode state come
    back as DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    def prefill(batch: dict, max_len: int):
        if not _dtensor(model.embed):
            place_params(model, mesh, rules)
        install_cell_hooks(mesh, rules, "prefill")
        try:
            with implicit_replication(), torch.no_grad():
                bsh = batch_shardings(batch, mesh, rules)
                b = {k: _place(v, mesh, bsh[k]) for k, v in batch.items()}
                if model.cfg.family == "encdec":
                    return model.prefill(b["tokens"], max_len,
                                         frames=b["frames"])
                return model.prefill(b["tokens"], max_len,
                                     positions3=b.get("positions3"),
                                     embeds=b.get("embeds"))
        finally:
            acts.clear_hooks()

    return prefill


def build_cell(arch: str, shape: str, mesh, multi_pod: bool = False,
               smoke: bool = False, opt_override: str | None = None,
               extra_rules: dict | None = None) -> Cell:
    """One (arch x shape x mesh) cell: the model on ``meta``, its inputs,
    their parts under the mode's rules (with :func:`arch_rule_overrides`
    and ``extra_rules``), and the step."""
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer

    spec = cfglib.input_specs(arch, shape, smoke=smoke)
    cfg, sp = spec["cfg"], spec["shape"]
    if spec["skip"]:
        return Cell(arch, shape, cfg, sp.kind, None, (), skip=spec["skip"])
    mode = "train" if sp.kind == "train" else "serve"
    rules = rules_for(mode, multi_pod)
    rules.update(arch_rule_overrides(arch, mode, multi_pod))
    if extra_rules:
        rules.update(extra_rules)
    model = build_model(cfg, device="meta", seed=None,
                        trainable=sp.kind == "train")
    axes = model.param_specs()
    shardings = {"params": {
        name: named_sharding_for(axes[name], tuple(p.shape), mesh, rules)
        for name, p in model.named_parameters()}}

    def serve(fn):
        def step(*args):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            if not _dtensor(model.embed):
                place_params(model, mesh, rules)
            install_cell_hooks(mesh, rules, sp.kind)
            try:
                with implicit_replication(), torch.no_grad():
                    return fn(*args)
            finally:
                acts.clear_hooks()
        return step

    if sp.kind == "train":
        opt_name = opt_override or OPT_FOR_ARCH.get(cfglib.canonical(arch),
                                                    "adamw")
        opt_init, opt_update = make_optimizer(opt_name, LR)
        opt_state = opt_init(param_tree(model))
        pspecs, pshapes = tree_specs(model)
        shardings["opt_state"] = opt_state_shardings(opt_name, pspecs,
                                                     pshapes, mesh, rules)
        shardings["batch"] = batch_shardings(spec["batch"], mesh, rules)

        def train_step(opt_state, batch, step):
            fn = make_sharded_train_step(model, opt_update, mesh, rules)
            return fn(opt_state, batch, step)

        return Cell(arch, shape, cfg, sp.kind, train_step,
                    (opt_state, spec["batch"], 0), shardings=shardings,
                    model=model)

    if sp.kind == "prefill":
        shardings["batch"] = batch_shardings(spec["batch"], mesh, rules)
        prefill = make_sharded_prefill(model, mesh, rules)
        return Cell(arch, shape, cfg, sp.kind,
                    lambda batch: prefill(batch, sp.seq_len),
                    (spec["batch"],), shardings=shardings, model=model)

    state = spec["batch"]["state"]
    bax = rules["batch"]
    shardings["state"] = ssh = state_parts(model.decode_state_specs(),
                                           state, mesh, rules)
    shardings["token"] = tok = (bax if state_shapes_batch_divisible(
        state, model.decode_state_specs(), mesh, bax) else None,)

    def serve_step(token, state):
        token = _place(token, mesh, tok)
        place_tree(state, ssh, mesh)
        logits, state = model.decode_step(token, state)
        # the argmax over every vocabulary row of the batch
        next_tok = acts.replicate(logits).argmax(-1).to(torch.int32)
        # the reference's out_shardings: the token's and the state's
        next_tok = next_tok.redistribute(mesh, placements_for(tok, mesh))
        for owner, k, pt in _leaves(state, ssh):
            owner[k] = owner[k].redistribute(mesh, placements_for(pt, mesh))
        return next_tok, state

    return Cell(arch, shape, cfg, sp.kind, serve(serve_step),
                (spec["batch"]["token"], state), shardings=shardings,
                model=model)
