"""Mamba (S6) selective state-space mixer: prefill through the scan kernel,
one-token decode through the step recurrence.

Counterpart of ``repro.models.mamba``. in_proj -> (x, z); causal depthwise
conv over the sequence; data-dependent (dt, B, C) projections; the
selective scan ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
``y_t = C_t h_t + D x_t``; gated output ``y * silu(z)``; out_proj.

:func:`apply_mamba` (prefill) always takes the reference's kernel route
(``REPRO_OPT=sscan_kernel``, ``models/mamba.py:88-104`` there): the (dt, B,
C) projections for the whole sequence, then
:func:`repro_torch.kernels.selective_scan.selective_scan` — one op: the
CUDA kernel for CUDA tensors, the step recurrence for CPU tensors, placed
by its own rule on DTensors — then the ``D`` skip
term and the ``silu(z)`` gate; its final state is the decode carry. The
kernel is forward-only. :func:`apply_mamba_train` is the route of
``Transformer.train_forward``: the reference's default route (without
``mamba_dbc``), the same projections taken up front and the step
recurrence run in chunks of :func:`_pick_chunk` steps, each under
``torch.utils.checkpoint``, so that backward keeps only the chunks'
boundary states. Plain PyTorch on both devices.

Parameters are a mapping with the reference's leaf names and
orientation (``[d_in, d_out]``): ``w_in [d, 2*di]``, ``conv [K, di]``,
``w_xdbc [di, dt_rank + 2N]``, ``w_dt [dt_rank, di]``, ``dt_bias [di]``,
``a_log [di, N]``, ``d_skip [di]``, ``w_out [di, d]``; ``a_log``,
``dt_bias`` and ``d_skip`` are float32 whatever the model dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.activations import on_shards, reduce_partial
from repro_torch.kernels.selective_scan import selective_scan

from .recurrence import cat_chunks, stack_steps, steps

#: parameter leaves kept in float32 whatever the model dtype
F32_LEAVES = ("a_log", "dt_bias", "d_skip")
#: each leaf's logical axes (the reference's ``mamba_init`` specs)
MAMBA_SPECS = {"w_in": ("embed", "inner"), "w_xdbc": ("inner", None),
               "w_dt": (None, "inner"), "w_out": ("inner", "embed"),
               "conv": (None, "inner"), "a_log": ("inner", None),
               "dt_bias": ("inner",), "d_skip": ("inner",)}


def mamba_dims(d_model: int, expand: int, d_state: int):
    """``(d_inner, dt_rank, d_state)``."""
    di = expand * d_model
    dt_rank = -(-d_model // 16)
    return di, dt_rank, d_state


def mamba_shapes(d_model: int, expand: int, d_state: int,
                 d_conv: int) -> dict:
    """Leaf name -> shape."""
    di, dt_rank, N = mamba_dims(d_model, expand, d_state)
    return {"w_in": (d_model, 2 * di), "w_xdbc": (di, dt_rank + 2 * N),
            "w_dt": (dt_rank, di), "w_out": (di, d_model),
            "conv": (d_conv, di), "a_log": (di, N), "dt_bias": (di,),
            "d_skip": (di,)}


def mamba_init_(p: dict, gen: torch.Generator) -> dict:
    """Fill ``p`` in place with the reference's distributions (not its
    bits): dense weights truncated normal at fan-in scale, ``conv``
    N(0, 1/K), S4D-real ``a_log = log(1..N)``, ``dt_bias`` so that
    softplus(dt) spans (1e-3, 1e-1), ``d_skip`` 1."""
    from .layers import dense_init_
    for name in ("w_in", "w_xdbc", "w_dt", "w_out"):
        dense_init_(p[name], gen)
    K, di = p["conv"].shape
    N = p["a_log"].shape[1]
    dev = p["conv"].device
    with torch.no_grad():
        conv = torch.randn((K, di), generator=gen, device=dev)
        p["conv"].copy_(conv / math.sqrt(K))
        p["a_log"].copy_(torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=dev))[None, :].expand(di, N))
        u = torch.rand((di,), generator=gen, device=dev)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        p["dt_bias"].copy_(torch.log(torch.expm1(dt)))
        p["d_skip"].fill_(1.0)
    return p


def _pick_chunk(S: int, target: int = 128) -> int:
    """Largest divisor of S that is <= target (chunked-scan granularity)."""
    c = min(S, target)
    while S % c:
        c -= 1
    return c


def _dbc(p: dict, xc: torch.Tensor, dt_rank: int, N: int):
    """conv'd activations -> (dt [.., di], B [.., N], C [.., N]) in f32."""
    # on DTensors the product's partial sums over the channels are
    # reduced whole before the split, as GSPMD reduces them
    dbc = reduce_partial(xc @ p["w_xdbc"]).float()
    dt_lowrank, b, c = torch.split(dbc, [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt_lowrank @ p["w_dt"].float() + p["dt_bias"])
    return dt, b, c


def _gate_out(p: dict, y_s: torch.Tensor, xc: torch.Tensor, z: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """``(y_s + D x) * silu(z)`` in f32, cast, then out_proj."""
    y = y_s + xc.float() * p["d_skip"]
    y = (y * F.silu(z.float())).to(dtype)
    return y @ p["w_out"]


def _conv_in(p: dict, x: torch.Tensor):
    """x [B,S,D] -> (x after the causal conv and silu [B,S,di], z
    [B,S,di], the conv's padded input)."""
    S = x.shape[1]
    xi, z = (x @ p["w_in"]).chunk(2, dim=-1)                 # [B,S,di]
    K = p["conv"].shape[0]
    # the causal pad on S, on each rank's rows and channels (PyTorch
    # 2.11's DTensor pad gives a placement short of the mesh's dims)
    (xi_loc,), wrap = on_shards((xi,), (0, 2))
    xpad = wrap(F.pad(xi_loc, (0, 0, K - 1, 0)),
                (xi.shape[0], S + K - 1, xi.shape[2]))
    xc = sum(xpad[:, k:k + S] * p["conv"][k] for k in range(K))
    return F.silu(xc), z, xpad


def apply_mamba(p: dict, x: torch.Tensor, d_state: int,
                return_state: bool = False):
    """Prefill: ``x [B,S,D] -> y [B,S,D]``; with ``return_state`` also the
    decode carry ``{"conv": [B,K-1,di], "h": [B,di,N] f32}`` at step S."""
    S = x.shape[1]
    xc, z, xpad = _conv_in(p, x)
    dt, bb, cc = _dbc(p, xc, p["w_dt"].shape[0], d_state)
    a = -torch.exp(p["a_log"])
    y_s, h_fin = selective_scan(dt, bb, cc, xc, a, return_state=True)
    out = _gate_out(p, y_s, xc, z, x.dtype)
    if not return_state:
        return out
    conv_tail = xpad[:, S:S + p["conv"].shape[0] - 1]
    return out, {"conv": conv_tail.to(p["conv"].dtype), "h": h_fin}


def _scan_chunk(h: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, x: torch.Tensor, a: torch.Tensor):
    """The step recurrence over one chunk: ``h [B,di,N]``, dt/x
    ``[B,C,di]``, b/c ``[B,C,N]`` -> (``h`` after the chunk, y
    ``[B,C,di]``), in float32."""
    ys = []
    for t in range(steps("mamba", dt.shape[1], "mamba.chunks")):
        da = torch.exp(dt[:, t][..., None] * a)              # [B,di,N]
        dbx = dt[:, t][..., None] * b[:, t][:, None, :] * x[:, t][..., None]
        h = da * h + dbx
        # C_t h_t as a product and a sum: torch's CPU einsum / bmm are
        # many times slower at these small shapes
        ys.append((h * c[:, t, None, :]).sum(-1))
    return h, stack_steps(ys, dt.shape[1])


def apply_mamba_train(p: dict, x: torch.Tensor,
                      d_state: int) -> torch.Tensor:
    """Training: ``x [B,S,D] -> y [B,S,D]``, differentiable; the scan in
    checkpointed chunks of :func:`_pick_chunk` steps (on DTensors, on each
    rank's rows, every channel: ``distributed.activations.on_shards``,
    ``a`` whole on every rank, its gradient summed over the ranks that
    split the rows)."""
    B, S, _ = x.shape
    xc, z, _ = _conv_in(p, x)
    dt, bb, cc = _dbc(p, xc, p["w_dt"].shape[0], d_state)
    shape = dt.shape
    (dt, bb, cc, xf), wrap = on_shards((dt, bb, cc, xc.float()), (0,))
    a = wrap.params({"a": -torch.exp(p["a_log"])})["a"]
    h = torch.zeros((dt.shape[0], dt.shape[-1], d_state),
                    dtype=torch.float32, device=x.device)
    C = _pick_chunk(S)
    ys = []
    for j in range(steps("mamba.chunks", S // C)):
        sl = slice(j * C, (j + 1) * C)
        h, y = checkpoint(_scan_chunk, h, dt[:, sl], bb[:, sl], cc[:, sl],
                          xf[:, sl], a, use_reentrant=False)
        ys.append(y)
    return _gate_out(p, wrap(cat_chunks(ys, S // C), shape), xc, z,
                     x.dtype)


def mamba_state_init(batch: int, p: dict, d_state: int) -> dict:
    """Zeroed decode carry of one layer."""
    di = p["w_in"].shape[1] // 2
    K = p["conv"].shape[0]
    dev = p["conv"].device
    return {"conv": torch.zeros((batch, K - 1, di), dtype=p["conv"].dtype,
                                device=dev),
            "h": torch.zeros((batch, di, d_state), dtype=torch.float32,
                             device=dev)}


def mamba_decode_step(p: dict, x: torch.Tensor, state: dict, d_state: int
                      ) -> tuple[torch.Tensor, dict]:
    """One token ``x [B,1,D]`` -> ``(y [B,1,D], new state)``; the state is
    :func:`mamba_state_init`'s or :func:`apply_mamba`'s carry."""
    dt_rank = p["w_dt"].shape[0]
    N = d_state
    xi, z = (x[:, 0] @ p["w_in"]).chunk(2, dim=-1)           # [B,di]
    hist = torch.cat([state["conv"], xi[:, None]], 1)        # [B,K,di]
    xc = F.silu(torch.einsum("bkd,kd->bd", hist, p["conv"]))
    dt, b, c = _dbc(p, xc, dt_rank, N)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt[..., None] * a)
    h = da * state["h"] + dt[..., None] * b[:, None, :] \
        * xc.float()[..., None]
    y_s = torch.einsum("bdn,bn->bd", h, c)
    return _gate_out(p, y_s, xc, z, x.dtype)[:, None], \
        {"conv": hist[:, 1:], "h": h}
