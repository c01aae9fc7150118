"""GPipe-style pipeline parallelism over a mesh axis, on
``torch.distributed`` (counterpart of ``repro.distributed.pipeline``).

Stages hold contiguous layer blocks, one stage a rank of the mesh axis;
microbatches stream through with the classic GPipe schedule
(``n_micro + n_stages - 1`` ticks), and activations hop from stage ``i``
to stage ``(i + 1) % n`` by point-to-point send / receive, where the
reference's ``shard_map`` body uses ``lax.ppermute``. Every rank runs
the same program, as the ``shard_map`` body does on every device: at tick
``t`` stage 0 takes microbatch ``t`` (microbatch 0 once ``t >=
n_micro``: a bubble whose result nothing reads), every other stage what
its predecessor sent at tick ``t - 1``; the last stage keeps its output
of tick ``t`` as finished microbatch ``t - (n_stages - 1)``; at the end a
masked all-reduce over the axis hands the last stage's results to every
stage.

Autograd differentiates the whole pipeline, as XLA differentiates the
reference's ``ppermute``s into reverse hops:

* a hop is a ``torch.autograd.Function`` whose forward sends to the next
  stage and receives from the previous one (one ``batch_isend_irecv``,
  both posted before either is waited on, so the ring cannot deadlock),
  and whose backward sends the gradient the reverse way. As in the
  reference's traced body, every stage feeds the received tensor into
  its next tick and its later outputs into the result, through a
  ``torch.where`` that selects by stage (stage 0 its microbatch, the
  last stage its output), so every rank runs the backward of every hop
  but the last tick's (whose result no rank reads), in the same order;
* the final all-reduce is ``torch.distributed.nn.functional.all_reduce``,
  whose backward all-reduces the gradients: the gradient each rank gets
  is that of the sum of all ranks' losses. A loss computed alike on
  every rank from the replicated result counts once a rank (divide it by
  the stage count for one loss's gradient);
* each rank holds only its own stage's parameters, and the gradients
  reach them there.

A hop of CUDA tensors over a gloo group is staged through host memory
(gloo's send and receive read a tensor's pointer on the host); over NCCL
it moves directly. ``bubble_fraction`` is the reference's.
"""

from __future__ import annotations

import torch


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def _staged(group, device: torch.device) -> bool:
    """Whether a collective of tensors on ``device`` over ``group`` goes
    through host memory: the sharded pool's ring route rule (CUDA
    tensors over gloo)."""
    import torch.distributed as dist

    from repro_torch.paging.sharded_pool import ring_route
    return ring_route(dist.get_backend(group), device) == "gloo_staged"


def _send_recv(x: torch.Tensor, send_to: int, recv_from: int,
               group) -> torch.Tensor:
    """Send ``x`` to global rank ``send_to`` and receive a tensor like it
    from ``recv_from``, both posted in one batch before either is waited
    on."""
    import torch.distributed as dist
    staged = _staged(group, x.device)
    out = x.detach().contiguous()
    if staged:
        out = out.cpu()
    got = torch.empty_like(out)
    for w in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, out, send_to, group),
             dist.P2POp(dist.irecv, got, recv_from, group)]):
        w.wait()
    return got.to(x.device) if staged else got


class _RingHop(torch.autograd.Function):
    """Forward: ``y`` to the next stage, the previous stage's in return.
    Backward: the gradient to the previous stage, the next stage's in
    return."""

    @staticmethod
    def forward(ctx, y, group, nxt: int, prv: int):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _send_recv(y, nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.prv, ctx.nxt, ctx.group), None, None, None


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's stage slice ``[1, ...]`` of a stacked leaf: a DTensor's
    local shard (dim 0 sharded over the pipeline axis), or the tensor."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def pipeline_forward(stage_fn, params_stacked, x: torch.Tensor, *, mesh,
                     axis: str = "pod", n_micro: int | None = None
                     ) -> torch.Tensor:
    """Run ``stage_fn(stage_params, microbatch) -> microbatch`` as a
    pipeline over mesh axis ``axis`` of the DeviceMesh ``mesh`` (its size
    is the stage count), on every rank of that axis.

    ``params_stacked``: a tree (dicts, lists, tuples) of this rank's
    stage's parameters, each leaf ``[1, ...]`` (stage ``s``'s slice of the
    reference's ``[n_stages, ...]`` leaf, on rank ``s`` of the axis), or
    a DTensor with dim 0 sharded over the axis, whose local shard is that
    slice. ``x``: ``[B, ...]``, the same on every rank; ``B`` must divide
    into ``n_micro`` microbatches (default: the stage count, the GPipe
    minimum). Returns ``y [B, ...]`` after all stages, the same on every
    rank of the axis. Bubble fraction: :func:`bubble_fraction`."""
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    B = x.shape[0]
    n_micro = n_micro or n_stages
    if B % n_micro:
        raise ValueError(f"pipeline_forward: batch {B} does not divide "
                         f"into {n_micro} microbatches")
    mb = B // n_micro
    stage = _map(lambda t: _local(t)[0], params_stacked)
    xs = x.reshape(n_micro, mb, *x.shape[1:])
    nxt = dist.get_global_rank(group, (idx + 1) % n_stages)
    prv = dist.get_global_rank(group, (idx - 1) % n_stages)
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == n_stages - 1, device=x.device)
    buf = torch.zeros_like(xs[0])
    outs = [torch.zeros_like(xs[0])] * n_micro
    for t in range(n_micro + n_stages - 1):
        x_in = torch.where(first, xs[t if t < n_micro else 0], buf)
        y = stage_fn(stage, x_in)
        # the ring hop: the last stage's output wraps to stage 0, which
        # reads none of it
        buf = (_RingHop.apply(y, group, nxt, prv) if n_stages > 1
               else y)
        m = t - (n_stages - 1)
        if m >= 0:
            # every stage selects (its output on the last, zeros on the
            # rest), so that every rank's backward runs every hop's
            outs[m] = torch.where(last, y, outs[m])
    acc = torch.stack(outs)
    if _staged(group, acc.device):
        acc = all_reduce(acc.cpu(), group=group).to(x.device)
    else:
        acc = all_reduce(acc, group=group)
    return acc.reshape(B, *x.shape[1:])


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)
