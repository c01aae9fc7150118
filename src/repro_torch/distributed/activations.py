"""Activation sharding hooks (SP): models call them, the launcher installs
them.

Counterpart of ``repro.distributed.activations``. Every hook is the
identity by default, and on a tensor that is not a DTensor. The sharded
train step (``launch.steps.make_sharded_train_step``) installs them as the
reference's ``build_cell`` does for a train cell; on a DTensor an
installed hook redistributes it (differentiably: backward redistributes
the gradient back), as ``with_sharding_constraint`` pins an XLA array:

* :func:`activation_constraint`: the trunk's residual stream ``[B, S, D]``
  at every period boundary (and each encoder-decoder block's output);
* :func:`attn_constraint`: q / k / v before attention;
* :func:`matmul_input_constraint`: a block's normed input before its
  weight products, and each branch output before the residual add (its
  gradient then reaches the products gathered on the sequence);
* :func:`decode_logits_constraint`: decode attention's logits
  ``[B, Hkv, G, T]``;
* :func:`decode_state_constraint`: a new decode state's leaves, as the
  models' ``init_decode_state`` makes them (the dry run's cells place
  them by the models' ``decode_state_specs``, as the reference's jitted
  steps take a state of those shardings).

The port calls the last three wherever the reference's perf flags would
(``attn_reshard``, ``mm_gather``, ``decode_tsh``), whatever the flags:
an uninstalled hook changes nothing, and an installed one changes only
the layout, not a value.
"""

from __future__ import annotations

import threading

import torch

_state = threading.local()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def set_activation_sharding(mesh, placements) -> None:
    """Install (or clear, with ``placements=None``) the trunk activation
    constraint: ``placements`` one a mesh dim."""
    _state.value = None if placements is None else (mesh, tuple(placements))


def activation_constraint(x):
    """Apply the installed constraint to a ``[B, S, D]`` DTensor."""
    sh = getattr(_state, "value", None)
    if sh is None or x.dim() != 3 or not is_dtensor(x):
        return x
    return x.redistribute(*sh)


def set_attn_sharding(fn) -> None:
    """Install a ``(q, k, v) -> (q, k, v)`` resharding hook (``None``
    clears it)."""
    _state.attn = fn


def attn_constraint(q, k, v):
    fn = getattr(_state, "attn", None)
    if fn is None or not is_dtensor(q):
        return q, k, v
    return fn(q, k, v)


def set_matmul_input_sharding(fn) -> None:
    """Install the pre-matmul activation constraint (``None`` clears
    it)."""
    _state.mm = fn


def matmul_input_constraint(y):
    fn = getattr(_state, "mm", None)
    return y if fn is None or not is_dtensor(y) else fn(y)


def set_decode_logits_sharding(fn) -> None:
    """Install a constraint for decode attention's logits ``[B, Hkv, G,
    T]`` (``None`` clears it)."""
    _state.decode_logits = fn


def decode_logits_constraint(s):
    fn = getattr(_state, "decode_logits", None)
    return s if fn is None or not is_dtensor(s) else fn(s)


def set_decode_state_sharding(fn) -> None:
    """Install a ``(state, specs) -> state`` hook that places the leaves
    of a new decode state by their logical axes ``specs`` (``None``
    clears it)."""
    _state.decode_state = fn


def decode_state_constraint(state: dict, specs):
    """``state`` through the installed hook, ``specs()`` its leaves'
    logical axes (called only when a hook is installed)."""
    fn = getattr(_state, "decode_state", None)
    return state if fn is None else fn(state, specs())


def replicate(x):
    """A DTensor redistributed to ``Replicate()`` on every mesh dim (the
    all-gather or all-reduce GSPMD would insert); any other tensor as it
    is. For the ops of the train route whose sharded form DTensor lacks
    or gets wrong (``launch.steps`` names them)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def reduce_partial(x):
    """A DTensor with its partial sums reduced (each ``Partial`` placement
    made ``Replicate``, its shards kept): the all-reduce GSPMD inserts
    before an op that needs whole values; any other tensor as it is.
    PyTorch 2.11's DTensor can neither turn a shard into a partial sum
    (an add of a sharded bias to a partial product asks for it) nor
    differentiate the reverse, so code that lays a DTensor out anew
    passes it here first."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def split_evenly(x, dim: int, groups: int):
    """``x`` itself, or, for a DTensor whose dim ``dim`` is sharded over
    mesh dims whose product does not divide ``groups`` (the heads that
    dim is about to be unflattened into), ``x`` with those mesh dims
    replicated first: the reshard GSPMD inserts before such a reshape,
    which DTensor refuses on an uneven split."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh, pl = x.device_mesh, list(x.placements)
    dim %= x.dim()
    on = [i for i, p in enumerate(pl) if p.is_shard() and p.dim % x.dim() == dim]
    split = 1
    for i in on:
        split *= mesh.size(i)
    if groups % split == 0:
        return x
    for i in on:
        pl[i] = Replicate()
    return x.redistribute(mesh, pl)


class _GradAs(torch.autograd.Function):
    """The identity forward; backward redistributes the gradient to the
    placements given."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def grad_as_forward(x):
    """``x`` itself; on a DTensor, its gradient is redistributed to ``x``'s
    own placements before it reaches the op that made ``x`` (DTensor may
    hand back a gradient in the layout of the op that consumed ``x``)."""
    if not is_dtensor(x):
        return x
    return _GradAs.apply(x, tuple(x.placements))


class _LocalParam(torch.autograd.Function):
    """A DTensor parameter as the whole plain tensor every rank holds;
    backward sums each rank's gradient over the mesh dims ``split`` (those
    that split the activations the local code read beside it) and lays
    it out as the parameter, so that it leaves reduced."""

    @staticmethod
    def forward(ctx, p, split):
        from torch.distributed.tensor import Replicate
        ctx.mesh, ctx.placements, ctx.split = (p.device_mesh, p.placements,
                                               split)
        return p.redistribute(p.device_mesh,
                              [Replicate()] * p.device_mesh.ndim).to_local()

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        pl = [Partial() if i in ctx.split else Replicate()
              for i in range(ctx.mesh.ndim)]
        g = DTensor.from_local(g.contiguous(), ctx.mesh, pl)
        return g.redistribute(ctx.mesh, ctx.placements), None


class _Wrap:
    """What :func:`on_shards` hands back beside the local tensors."""

    def __init__(self, mesh=None, placements=None):
        self.mesh, self.placements = mesh, placements

    def __call__(self, t, shape, dims=None):
        """The local result ``t`` as the DTensor of global ``shape``,
        placed as the first input was; ``dims`` maps each kept dim of
        that input to the dim of ``t`` it lands on, for a result of
        another layout."""
        if self.mesh is None:
            return t
        from torch.distributed.tensor import DTensor, Shard
        pl = self.placements
        if dims is not None:
            pl = [Shard(dims[p.dim]) if p.is_shard() else p for p in pl]
        full = torch.empty(shape, device="meta")
        return DTensor.from_local(t.contiguous(), self.mesh, pl,
                                  shape=full.shape, stride=full.stride())

    def local(self, t):
        """This rank's shard of another DTensor ``t`` laid out as the
        first input was (``t`` shares its leading dims)."""
        if self.mesh is None:
            return t
        return reduce_partial(t).redistribute(self.mesh,
                                              self.placements).to_local()

    def params(self, p: dict) -> dict:
        """The DTensor parameters ``p`` (a mapping) as whole plain tensors
        for the local code (:class:`_LocalParam`): each rank's gradient of
        one is summed over the mesh dims that split the local inputs
        before it reaches the parameter, as GSPMD reduces the gradient of
        a replicated weight read by batch-sharded rows."""
        if self.mesh is None:
            return p
        split = tuple(i for i, q in enumerate(self.placements)
                      if q.is_shard())
        return {k: _LocalParam.apply(v, split) if is_dtensor(v) else v
                for k, v in p.items()}


def on_shards(tensors, dims: tuple, divides=None):
    """Hand DTensors to code that runs on each rank's own shards, as
    GSPMD runs an op that is independent along some dims (attention over
    batch and heads, a recurrence over batch rows and heads).

    ``tensors`` are redistributed to the placements of the first, with
    only its shards of tensor dims ``dims`` kept (``divides(placements)``
    may narrow them: it returns the dims to keep). Returns ``(local
    tensors, wrap)``, where ``wrap(local, shape)`` is the DTensor of those
    placements and global ``shape`` (``wrap(local, shape, dims)`` for a
    result of another layout), ``wrap.local(t)`` this rank's shard of
    another DTensor of the same leading layout, and ``wrap.params(p)``
    the parameters the local code reads, whole on every rank, their
    gradients summed over the ranks that split the inputs. A gradient
    the local code makes of anything else is its rank's own. Tensors
    that are not DTensors pass through, and ``wrap``, ``wrap.local`` and
    ``wrap.params`` are the identity."""
    if not tensors or not is_dtensor(tensors[0]):
        return list(tensors), _Wrap()
    from torch.distributed.tensor import Replicate

    mesh = tensors[0].device_mesh
    keep = lambda pl, ds: [p if p.is_shard() and p.dim in ds
                           else Replicate() for p in pl]
    pl = keep(tensors[0].placements, dims)
    if divides is not None:
        pl = keep(pl, divides(pl))
    loc = [reduce_partial(t).redistribute(mesh, pl).to_local()
           for t in tensors]
    return loc, _Wrap(mesh, tuple(pl))


def clear_hooks() -> None:
    """Clear every installed hook."""
    set_activation_sharding(None, None)
    for setter in (set_attn_sharding, set_matmul_input_sharding,
                   set_decode_logits_sharding, set_decode_state_sharding):
        setter(None)
