"""The cost pass of one executed step, per rank: FLOPs, collectives and an
HBM-write estimate (counterpart of ``repro.launch.hlo_analysis``).

The reference parses XLA's partitioned HLO text: it splits it into
computations, scales each ``while`` body by its trip count, and sums
collective output bytes and post-fusion op output bytes. The port has no
HLO to parse. It runs the step once, eagerly, on ``meta`` tensors placed
as DTensors on the cell's mesh (``launch.steps.build_cell``), and counts
what this rank executes, through three dispatch modes:

* **FLOPs.** ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention, and the selective scan's own,
  ``kernels.selective_scan.ops.scan_flops``) over every op this rank
  runs on its local shards (``flops``). ``FlopCounterMode`` over the
  same step counts each DTensor op at its global shapes and each plain
  op as it runs, which is the whole step's count (``flops_global``): the
  figure to hold against an analytic count.
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
The time loops of the recurrences are the exception: a full run of them
is 32,768 steps a layer at prefill, and each op under the three modes
costs about 0.1 ms on the host. :func:`analyze_step` given ``fresh`` runs
them loop-aware instead: one step, then two, scaled to the trip count
(``models.recurrence``), exactly as a full run counts them (a test holds
the two equal at a short sequence). Eager PyTorch also fuses nothing, so
the write estimate counts every elementwise op's output where the
reference's counts one write a fused op: the two write estimates are
not comparable across frameworks. The
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


def _count(fn, args):
    """Run ``fn(*args)`` once under the three modes: ``(fn's result,
    counts)``."""
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


def _add_steps(total, two, one, n: int):
    """``total`` plus ``n`` times ``two - one``, key by key (nested
    dicts; a key one run lacks counts 0 there)."""
    if isinstance(total, dict) or isinstance(two, dict):
        total, two, one = (t if isinstance(t, dict) else {}
                           for t in (total, two, one))
        return {k: _add_steps(total.get(k, 0), two.get(k, 0),
                              one.get(k, 0), n)
                for k in {**total, **two}}
    return total + n * (two - one)


def analyze_step(fn, *args, fresh=None):
    """Run ``fn(*args)`` under the three modes; returns ``(fn's result,
    counts)``: ``flops`` (this rank's), ``flops_global``, ``collectives``
    (type -> count and output bytes, this rank's),
    ``collectives_comm_debug`` (type -> count), ``hbm_write_bytes``,
    ``n_ops`` (this rank's ops on plain tensors) and ``loop_counts``.

    Without ``fresh`` every step of every loop runs, and ``loop_counts``
    is empty. With ``fresh``, a callable that gives a new ``(fn, args)``
    of the same step (the step mutates what it is given), the counts are
    loop-aware: the loops of ``models.recurrence`` run one step each;
    then, for each trip count ``T`` over 1 (and product ``R`` of the trip
    counts of the loops it runs within), the counts gain ``R (T - 1)``
    times the difference between two fresh steps, one with the loops of
    that ``T`` and ``R`` at two steps (the others at one) and one with
    every loop at one. (The fresh steps are a process's second sight of
    the cell: the first run of a cell counts a few ops and bytes more,
    DTensor filling its caches; FLOPs and collectives are the same.)
    Every step of a recurrence does the same work, so this is every
    step's count exactly; ``loop_counts``
    gives each loop's trip count and executions (a layer's loop, a
    chunk's, a checkpoint's recompute)."""
    from repro_torch.models import recurrence

    if fresh is None:
        out, counts = _count(fn, args)
        return out, {**counts, "loop_counts": {}}
    recurrence.set_step_caps({})
    try:
        out, total = _count(fn, args)
        trips = recurrence.noted_trips()
        groups = {}
        for name, t in trips.items():
            if t["trip_count"] > 1:
                outer, runs = t["within"], 1
                while outer is not None:
                    runs *= trips[outer]["trip_count"]
                    outer = trips[outer]["within"]
                groups.setdefault((t["trip_count"], runs), []).append(name)
        one = None
        for (T, runs), names in sorted(groups.items()):
            if one is None:
                recurrence.set_step_caps({})
                _, one = _count(*fresh())
            recurrence.set_step_caps(dict.fromkeys(names, 2))
            _, two = _count(*fresh())
            total = _add_steps(total, two, one, runs * (T - 1))
    finally:
        recurrence.set_step_caps(None)
    return out, {**total, "loop_counts": trips}
