"""The cost pass of one executed step, per rank: FLOPs, collectives and an
HBM-write estimate (counterpart of ``repro.launch.hlo_analysis``).

The reference parses XLA's partitioned HLO text: it splits it into
computations, scales each ``while`` body by its trip count, and sums
collective output bytes and post-fusion op output bytes. The port has no
HLO to parse. It runs the step once, eagerly, on ``meta`` tensors placed
as DTensors on the cell's mesh (``launch.steps.build_cell``), and counts
what this rank executes, through three dispatch modes:

* **FLOPs.** ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention) over every op this rank runs on its local
  shards (``flops``). ``FlopCounterMode`` over the same step counts each
  DTensor op at its global shapes and each plain op as it runs, which is
  the whole step's count (``flops_global``): the figure to hold against
  an analytic count.
* **Collectives.** Each ``_c10d_functional`` collective that DTensor's
  redistributions issue on this rank's shards, by the reference's type
  names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``, ``broadcast``), as a count and its output bytes;
  DTensor's ``CommDebugMode`` counts the same ops by type beside
  (``collectives_comm_debug``).
* **HBM writes.** The output bytes of every op this rank runs whose
  output is not a view or an in-place alias of an input.

The ops DTensor runs on fake tensors to learn an output's global shape
(its sharding propagation) are not the step's, and are not counted.

Eager PyTorch runs every iteration of every loop (the trunk's layers,
the attention's key blocks, the loss's chunks), so these counts already
include each loop's trip count: there is no trip-count parser to port.
Eager PyTorch also fuses nothing, so the write estimate counts every
elementwise op's output where the reference's counts one write a fused
op: the two write estimates are not comparable across frameworks. The
reference's ``SKIP_OPS`` list (TPU lowering corrections) has no
counterpart either.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

#: ``_c10d_functional`` collectives -> the reference's type names
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


def _written(func, out) -> int:
    """Output bytes of ``func``'s returns that alias no input."""
    rets = func._schema.returns
    outs = out if isinstance(out, (list, tuple)) and len(rets) > 1 else [out]
    return sum(_bytes(o) for r, o in zip(rets, outs) if r.alias_info is None)


def _is_dtensor_op(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


class OpTally(TorchDispatchMode):
    """Counts the ops this rank runs on plain tensors: a DTensor op is
    handed on (``NotImplemented``) so that DTensor runs it, and the local
    ops and collectives it issues come back here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.hbm_write_bytes = 0
        self.n_ops = 0
        self.collectives: dict[str, dict] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out      # DTensor's shape propagation, not the step
        packet = func._overloadpacket
        self.n_ops += 1
        formula = self.registry.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVES.get(packet.__name__)
            if kind is not None:
                d = self.collectives.setdefault(kind,
                                                {"count": 0, "bytes": 0})
                d["count"] += 1
                d["bytes"] += _bytes(out)
        self.hbm_write_bytes += _written(func, out)
        return out


def analyze_step(fn, *args):
    """Run ``fn(*args)`` once under the three modes; returns ``(fn's
    result, counts)``: ``flops`` (this rank's), ``flops_global``,
    ``collectives`` (type -> count and output bytes, this rank's),
    ``collectives_comm_debug`` (type -> count), ``hbm_write_bytes`` and
    ``n_ops`` (this rank's ops on plain tensors)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    # the last mode entered sees each op first: FlopCounterMode counts a
    # DTensor op at its global shapes, then OpTally hands it to DTensor
    # and counts the local ops it runs
    with CommDebugMode() as comm, OpTally() as tally, \
            FlopCounterMode(display=False) as fc:
        out = fn(*args)
    debug = {}
    for op, n in comm.get_comm_counts().items():
        name = getattr(op, "__name__", str(op)).split(".")[-1]
        kind = COLLECTIVES.get(name, name)
        debug[kind] = debug.get(kind, 0) + n
    return out, {"flops": tally.flops, "flops_global": fc.get_total_flops(),
                 "collectives": tally.collectives,
                 "collectives_comm_debug": debug,
                 "hbm_write_bytes": tally.hbm_write_bytes,
                 "n_ops": tally.n_ops}
