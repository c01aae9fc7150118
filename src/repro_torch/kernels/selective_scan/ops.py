"""Selective scan: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors (or when the caller opts out).

The scan is one operator, ``torch.ops.repro_torch.selective_scan``
(``torch.library.custom_op``), so that a caller holding DTensors, the
meta device or a dispatch mode sees it once, not once a time step:

* its CUDA implementation launches the kernel (``selective_scan_fwd``) or
  raises; every other device runs the plain step recurrence
  (``ref._scan``);
* its fake implementation gives the outputs' shapes, so the meta device
  and fake tensors run it without a loop;
* its FLOP formula (:func:`scan_flops`) counts the recurrence's work for
  ``torch.utils.flop_counter``;
* its DTensor placement rule (:func:`_register_placements`, installed at
  the first DTensor call) runs it on each rank's shards of the batch
  (``b`` / ``c`` with it) or of the channels (``a``'s rows with them).

Forward-only, as the reference's kernel: under grad mode an input that
requires grad raises on either device, since the kernel's output would be
cut from the autograd graph without a word. The Mamba mixer's training
route is ``repro_torch.models.mamba.apply_mamba_train``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from .kernel import X_DTYPES, selective_scan_fwd
from .ref import _scan


def _kernel_views(dt, b, c, x, a):
    """The inputs as the kernel takes them. The model's own (f32 ``dt``,
    f32 or bf16 ``x``, ``b`` / ``c`` strided views of one projection, a
    contiguous ``a``) pass as they are; any other dtype is cast to f32 and
    a view without a unit inner stride copied, explicitly, here."""
    f32 = lambda t: t if t.dtype == torch.float32 else t.float()
    dt, b, c, a = map(f32, (dt, b, c, a))
    if x.dtype not in X_DTYPES:
        x = x.float()
    unit = lambda t: t if t.shape[-1] == 1 or t.stride(-1) == 1 \
        else t.contiguous()
    return (*map(unit, (dt, b, c, x)), a.contiguous())


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=())
def scan_op(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
            x: torch.Tensor, a: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """dt/x [B,S,di], b/c [B,S,N], a [di,N] -> (y [B,S,di], h_S [B,di,N]),
    both float32: the plain step recurrence (every device but CUDA)."""
    return _scan(dt, b, c, x, a)


@scan_op.register_kernel("cuda")
def _scan_cuda(dt, b, c, x, a):
    return selective_scan_fwd(*_kernel_views(dt, b, c, x, a))


@scan_op.register_fake
def _scan_fake(dt, b, c, x, a):
    B, S, di = dt.shape
    return (dt.new_empty((B, S, di), dtype=torch.float32),
            dt.new_empty((B, di, a.shape[-1]), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.selective_scan)
def scan_flops(dt_shape, b_shape, c_shape, x_shape, a_shape, *args,
               out_shape=None, **kwargs) -> int:
    """``B S di (7 N + 1)``: a state update (``B S di N`` of them) takes
    ``dt a``, its ``exp``, ``da h``, the product with ``b``, the add,
    the product with ``c`` and the add of the sum over N (7); a (step,
    channel) takes ``dt x`` once (1)."""
    B, S, di = dt_shape
    return B * S * di * (7 * a_shape[-1] + 1)


@functools.cache
def _register_placements() -> None:
    """DTensor's rule for the op, one mesh dim at a time: everything
    replicated; the batch sharded (``dt``, ``b``, ``c``, ``x``, ``y`` and
    ``h`` on dim 0, ``a`` replicated); or the channels sharded (``dt``,
    ``x``, ``y`` on dim 2, ``h`` on dim 1, ``a`` on dim 0, ``b`` / ``c``
    replicated). Each (sequence, channel) recurs alone, so every shard
    computes what the whole op computes there."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.selective_scan.default)
    def _placements(dt, b, c, x, a):
        R = Replicate()
        return [([R, R], [R, R, R, R, R]),
                ([Shard(0), Shard(0)], [Shard(0), Shard(0), Shard(0),
                                        Shard(0), R]),
                ([Shard(2), Shard(1)], [Shard(2), R, R, Shard(2),
                                        Shard(0)])]


def selective_scan(dt, b, c, x, a, *, use_kernel: bool = True,
                   return_state: bool = False):
    """dt/x [B,S,di], b/c [B,S,N], a [di,N] -> y [B,S,di] (dt's dtype), and
    with ``return_state`` also the float32 decode carry ``h_S [B,di,N]``
    (``h_0 = 0``). A CUDA ``dt`` goes through the kernel (or raises);
    ``use_kernel=False`` runs the plain version on any device."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (dt, b, c, x, a)):
        raise RuntimeError(
            "selective_scan is forward-only: an input requires grad under "
            "grad mode, and the output would be cut from the autograd "
            "graph; train through repro_torch.models.mamba."
            "apply_mamba_train (Transformer.train_forward)")
    if not use_kernel:
        y, h = _scan(dt, b, c, x, a)
    else:
        if type(dt) is not torch.Tensor:
            from repro_torch.distributed.activations import is_dtensor
            if is_dtensor(dt):
                _register_placements()
        y, h = scan_op(dt, b, c, x, a)
    y = y.to(dt.dtype)
    return (y, h) if return_state else y
