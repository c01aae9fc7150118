"""xLSTM mixers: mLSTM (matrix memory) and sLSTM (scalar memory,
block-diagonal recurrence), prefill and one-token decode.

Counterpart of ``repro.models.xlstm`` (Beck et al. 2024, arXiv:2405.04517).
Both cells gate exponentially with the max-stabiliser ``m``, which starts
at 0 (not -inf), as there::

  m_t = max(f~_t + m_{t-1}, i~_t)
  i = exp(i~_t - m_t),  f = exp(f~_t + m_{t-1} - m_t)

* mLSTM: a causal conv over the up-projection's first half ``a`` gives
  ``xc``; q and k come from ``xc``, v from ``a`` (the pre-conv branch),
  each through per-head ``[dh, dh]`` block-diagonal weights; the memory
  ``C [dh, dh]`` a head is read as ``h = C q / max(|n . q|, 1)``.
* sLSTM: four gates (z, i, f, o) at model width from the input projection
  ``w [d, 4d]`` plus a per-head recurrence ``r [4, H, dh, dh]``.

The reference runs prefill and training through one chunked ``lax.scan``
with remat. Here prefill (:func:`apply_mlstm`, :func:`apply_slstm`) is a
plain loop over time (the projections, conv and gates computed for the
whole sequence first; on DTensors the loop runs on each rank's rows, the
mLSTM's on its heads too, through ``distributed.activations.on_shards``,
and the dry run counts it loop-aware through ``models.recurrence``), and
the train route (:func:`apply_mlstm_train`, :func:`apply_slstm_train`,
for ``Transformer.train_forward``) runs the same loop in chunks of
``mamba._pick_chunk(S)`` steps, each under ``torch.utils.checkpoint``,
so that backward keeps the ``[B, H, dh, dh]`` matrix memory only at
chunk boundaries, as the reference's
``jax.checkpoint`` on its chunk does. The recurrences run in float32,
each step in few ops (the outer product and the reads of ``C`` as a
broadcast product and a batched matmul; the inputs unbound once a
chunk): a step's host dispatch, not its bytes, is its cost. The floors
``max(., 1)`` are ``torch.maximum``, whose gradient splits at a tie as
``jnp.maximum``'s does (an sLSTM normaliser is exactly 1 whenever the
input gate wins the first step). Parameters are mappings with the
reference's leaf names and orientation (``[d_in, d_out]``);
:data:`F32_LEAVES` stay float32 whatever the model dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.activations import on_shards, split_evenly

from .mamba import _pick_chunk
from .recurrence import cat_chunks, stack_steps, step_inputs, steps

#: parameter leaves kept in float32 whatever the model dtype
F32_LEAVES = ("f_bias", "i_bias", "skip", "bias")
#: each leaf's logical axes (the reference's ``mlstm_init`` /
#: ``slstm_init`` specs)
MLSTM_SPECS = {"w_up": ("embed", "inner"), "w_q": ("heads", None, None),
               "w_k": ("heads", None, None), "w_v": ("heads", None, None),
               "w_if": ("inner", None), "w_o": ("inner", "inner"),
               "w_dn": ("inner", "embed"), "conv": (None, "inner"),
               "f_bias": (None,), "i_bias": (None,), "skip": ("inner",)}
SLSTM_SPECS = {"w": ("embed", None), "r": (None, None, None, None),
               "w_dn": ("embed", "embed"), "bias": (None,)}


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------
def mlstm_shapes(d: int, n_heads: int, proj_factor: float,
                 d_conv: int) -> dict:
    """Leaf name -> shape."""
    di = int(proj_factor * d)
    dh = di // n_heads
    return {"w_up": (d, 2 * di), "w_q": (n_heads, dh, dh),
            "w_k": (n_heads, dh, dh), "w_v": (n_heads, dh, dh),
            "w_if": (di, 2 * n_heads), "w_o": (di, di), "w_dn": (di, d),
            "conv": (d_conv, di), "f_bias": (n_heads,),
            "i_bias": (n_heads,), "skip": (di,)}


def _block_diag_init_(w: torch.Tensor, gen: torch.Generator) -> None:
    """N(0, 1/dh) for ``[..., dh, dh]`` per-head weights, drawn in f32."""
    f = torch.randn(w.shape, generator=gen, device=w.device)
    w.copy_(f / math.sqrt(w.shape[-1]))


def mlstm_init_(p: dict, gen: torch.Generator) -> dict:
    """Fill ``p`` in place with the reference's distributions (not its
    bits): dense weights truncated normal at fan-in scale, q / k / v
    N(0, 1/dh), ``conv`` the identity on the last tap, forget bias 3,
    input bias 0, skip 1."""
    from .layers import dense_init_
    for name in ("w_up", "w_if", "w_o", "w_dn"):
        dense_init_(p[name], gen)
    with torch.no_grad():
        for name in ("w_q", "w_k", "w_v"):
            _block_diag_init_(p[name], gen)
        p["conv"].zero_()
        p["conv"][-1] = 1.0
        p["f_bias"].fill_(3.0)
        p["i_bias"].zero_()
        p["skip"].fill_(1.0)
    return p


def _mlstm_qkv(p: dict, xc: torch.Tensor, xv: torch.Tensor):
    """q, k (from ``xc``; k scaled by 1/sqrt(dh)) and v (from ``xv``)
    ``[..., H, dh]`` in float32."""
    H, dh = p["w_q"].shape[:2]
    xc, xv = (split_evenly(t, -1, H) for t in (xc, xv))
    xch = xc.reshape(*xc.shape[:-1], H, dh)
    xvh = xv.reshape(*xv.shape[:-1], H, dh)
    q = torch.einsum("...hk,hkv->...hv", xch, p["w_q"]).float()
    k = torch.einsum("...hk,hkv->...hv", xch, p["w_k"]).float() \
        / math.sqrt(dh)
    v = torch.einsum("...hk,hkv->...hv", xvh, p["w_v"]).float()
    return q, k, v


def _mlstm_gates(p: dict, xc: torch.Tensor):
    """Raw input and forget gates ``[..., H]`` in float32, biased."""
    i_raw, f_raw = (xc @ p["w_if"]).float().chunk(2, dim=-1)
    return i_raw + p["i_bias"], f_raw + p["f_bias"]


def _one(x: torch.Tensor) -> torch.Tensor:
    """The 0-dim 1 of ``x``'s dtype and device: the floor of
    ``torch.maximum(., one)``, which takes ``jnp.maximum``'s gradient at
    a tie (half)."""
    return torch.ones((), dtype=x.dtype, device=x.device)


def _mlstm_cell(C, n, m, q, k, v, i_raw, f_raw, one=None):
    """One step of the matrix memory: ``(h [B,H,dh], C, n, m)``; ``one``
    is :func:`_one` (made here when not given)."""
    one = _one(C) if one is None else one
    m_new = torch.maximum(f_raw + m, i_raw)
    i_g = torch.exp(i_raw - m_new)[..., None]
    f_g = torch.exp(f_raw + m - m_new)[..., None]
    C = f_g[..., None] * C + i_g[..., None] * (k[..., :, None]
                                               * v[..., None, :])
    n = f_g * n + i_g * k
    num = (q[..., None, :] @ C)[..., 0, :]
    den = torch.maximum((n * q).sum(-1).abs(), one)
    return num / den[..., None], C, n, m_new


def _mlstm_scan(C, n, m, q, k, v, i_raw, f_raw, within=None):
    """The cell over every step of ``q``/``k``/``v [B,T,H,dh]`` and the
    gates ``[B,T,H]``: ``(h [B,T,H,dh], C, n, m)``. The inputs are
    unbound once, so that backward stacks their gradients once instead
    of a full-size zero tensor a step. ``within``: the loop this one runs
    in (``models.recurrence``)."""
    one, hs = _one(C), []
    T = q.shape[1]
    run = steps("mlstm", T, within)
    for qt, kt, vt, it, ft in zip(*(step_inputs(t, run) for t in
                                    (q, k, v, i_raw, f_raw))):
        h, C, n, m = _mlstm_cell(C, n, m, qt, kt, vt, it, ft, one)
        hs.append(h)
    return stack_steps(hs, T), C, n, m


def _mlstm_out(p: dict, h, xc, o, gate, dtype):
    """``(o * h + skip * xc) * silu(gate)`` in f32, cast, down-projected."""
    h = o * h + xc.float() * p["skip"]
    return (h * F.silu(gate.float())).to(dtype) @ p["w_dn"]


def _mlstm_in(p: dict, x: torch.Tensor):
    """The whole sequence's inputs of the recurrence: ``(apad, xc, gate,
    (q, k, v, i_raw, f_raw), o)``."""
    S = x.shape[1]
    a, gate = (x @ p["w_up"]).chunk(2, dim=-1)              # [B,S,di]
    K = p["conv"].shape[0]
    # the causal pad on each rank's batch rows (PyTorch 2.11's DTensor
    # has no working pad of a batch sharded over two mesh dims)
    (a_loc,), wrap = on_shards((a,), (0,))
    apad = wrap(F.pad(a_loc, (0, 0, K - 1, 0)),
                (a.shape[0], S + K - 1, a.shape[2]))
    xc = F.silu(sum(apad[:, j:j + S] * p["conv"][j] for j in range(K)))
    q, k, v = _mlstm_qkv(p, xc, a)                           # [B,S,H,dh]
    i_raw, f_raw = _mlstm_gates(p, xc)                       # [B,S,H]
    o = torch.sigmoid((xc @ p["w_o"]).float())
    return apad, xc, gate, (q, k, v, i_raw, f_raw), o


def _mlstm_recur(x: torch.Tensor, seq: tuple, chunked: bool):
    """The recurrence over ``seq`` (:func:`_mlstm_in`'s, ``[B,S,H,..]``)
    from the zero carry, on each rank's rows and heads when they are
    DTensors (``distributed.activations.on_shards``), in one pass or, with
    ``chunked``, in checkpointed chunks of ``_pick_chunk(S)`` steps:
    ``(h [B,S,H*dh], C, n, m)``."""
    B, S, H = seq[0].shape[:3]
    shape = seq[0].shape
    seq, wrap = on_shards(seq, (0, 2))
    b, _, h_loc, dh = seq[0].shape
    z = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=x.device)
    carry = (z(b, h_loc, dh, dh), z(b, h_loc, dh), z(b, h_loc))
    if not chunked:
        h, *carry = _mlstm_scan(*carry, *seq)
    else:
        Ck = _pick_chunk(S)
        hs = []
        for j in range(steps("mlstm.chunks", S // Ck)):
            i = j * Ck
            h, *carry = checkpoint(_mlstm_scan, *carry,
                                   *(t[:, i:i + Ck] for t in seq),
                                   within="mlstm.chunks",
                                   use_reentrant=False)
            hs.append(h)
        h = cat_chunks(hs, S // Ck)
    # the carry's batch and head dims are q's dims 0 and 2
    C, n, m = (wrap(t, (B, H) + tuple(t.shape[2:]), {0: 0, 2: 1})
               for t in carry)
    return wrap(h, shape).reshape(B, S, -1), C, n, m


def apply_mlstm(p: dict, x: torch.Tensor, return_state: bool = False):
    """Prefill: ``x [B,S,D] -> [B,S,D]``; with ``return_state`` also the
    decode carry ``{"conv" [B,K-1,di], "C" [B,H,dh,dh], "n" [B,H,dh],
    "m" [B,H]}`` (float32 but ``conv``) at step S. On DTensors the
    recurrence runs on each rank's rows and heads."""
    S = x.shape[1]
    apad, xc, gate, seq, o = _mlstm_in(p, x)
    h, C, n, m = _mlstm_recur(x, seq, chunked=False)
    out = _mlstm_out(p, h, xc, o, gate, x.dtype)
    if not return_state:
        return out
    K = p["conv"].shape[0]
    return out, {"conv": apad[:, S:S + K - 1].to(p["conv"].dtype),
                 "C": C, "n": n, "m": m}


def apply_mlstm_train(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Training: ``x [B,S,D] -> [B,S,D]``, differentiable; the recurrence
    in checkpointed chunks of ``_pick_chunk(S)`` steps (on DTensors, on
    each rank's rows and heads: ``distributed.activations.on_shards``)."""
    _, xc, gate, seq, o = _mlstm_in(p, x)
    h = _mlstm_recur(x, seq, chunked=True)[0]
    return _mlstm_out(p, h, xc, o, gate, x.dtype)


def mlstm_state_init(batch: int, p: dict) -> dict:
    """Zeroed decode carry of one mLSTM layer (``m`` 0, as the
    reference's)."""
    H, dh = p["w_q"].shape[:2]
    K, di = p["conv"].shape
    dev = p["conv"].device
    z = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=dev)
    return {"conv": torch.zeros((batch, K - 1, di), dtype=p["conv"].dtype,
                                device=dev),
            "C": z(batch, H, dh, dh), "n": z(batch, H, dh), "m": z(batch, H)}


def mlstm_decode_step(p: dict, x: torch.Tensor, state: dict
                      ) -> tuple[torch.Tensor, dict]:
    """One token ``x [B,1,D]`` -> ``(y [B,1,D], new state)``."""
    B = x.shape[0]
    a, gate = (x[:, 0] @ p["w_up"]).chunk(2, dim=-1)
    hist = torch.cat([state["conv"], a[:, None]], 1)         # [B,K,di]
    xc = F.silu(torch.einsum("bkd,kd->bd", hist, p["conv"]))
    q, k, v = _mlstm_qkv(p, xc, a)
    i_raw, f_raw = _mlstm_gates(p, xc)
    o = torch.sigmoid((xc @ p["w_o"]).float())
    h, C, n, m = _mlstm_cell(state["C"], state["n"], state["m"], q, k, v,
                             i_raw, f_raw)
    y = _mlstm_out(p, h.reshape(B, -1), xc, o, gate, x.dtype)
    return y[:, None], {"conv": hist[:, 1:], "C": C, "n": n, "m": m}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------
def slstm_shapes(d: int, n_heads: int) -> dict:
    """Leaf name -> shape."""
    dh = d // n_heads
    return {"w": (d, 4 * d), "r": (4, n_heads, dh, dh), "w_dn": (d, d),
            "bias": (4 * d,)}


def slstm_init_(p: dict, gen: torch.Generator) -> dict:
    """Fill ``p`` in place with the reference's distributions: dense
    weights truncated normal at fan-in scale, ``r`` N(0, 1/dh), the bias
    0 but the forget gate's 3."""
    from .layers import dense_init_
    dense_init_(p["w"], gen)
    dense_init_(p["w_dn"], gen)
    d = p["w_dn"].shape[0]
    with torch.no_grad():
        _block_diag_init_(p["r"], gen)
        p["bias"].zero_()
        p["bias"][2 * d:3 * d] = 3.0
    return p


def _slstm_step(p: dict, xw_t: torch.Tensor, carry: tuple,
                one: torch.Tensor | None = None) -> tuple:
    """One recurrence step; ``xw_t [B, 4D]`` the input's contribution,
    ``one`` :func:`_one` (made here when not given). The recurrence ``[4, B, H, dh]`` is laid out
    ``(4, B, D) -> (B, 4D)`` before the gates split, as the
    reference's."""
    h, c, n, m = carry                                       # [B,D] each
    one = _one(c) if one is None else one
    B, D = h.shape
    _, H, dh, _ = p["r"].shape
    h = split_evenly(h, 1, H)
    rec = torch.einsum("bhk,ghkv->gbhv", h.reshape(B, H, dh).to(p["r"].dtype),
                       p["r"])
    rec = rec.reshape(4, B, D).transpose(0, 1).reshape(B, 4 * D)
    raw = (xw_t + rec).float() + p["bias"]
    z_r, i_r, f_r, o_r = raw.chunk(4, dim=-1)
    m_new = torch.maximum(f_r + m, i_r)
    i_g, f_g = torch.exp(i_r - m_new), torch.exp(f_r + m - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_r)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_r) * c_new / torch.maximum(n_new, one)
    return h_new, c_new, n_new, m_new


def _slstm_scan(p: dict, xw: torch.Tensor, *carry, within=None):
    """The step over every ``xw [B,T,4D]``: ``(h [B,T,D], *carry)``
    (``xw`` unbound once, as in :func:`_mlstm_scan`)."""
    one, hs = _one(carry[0]), []
    T = xw.shape[1]
    for xw_t in step_inputs(xw, steps("slstm", T, within)):
        carry = _slstm_step(p, xw_t, carry, one)
        hs.append(carry[0])
    return (stack_steps(hs, T), *carry)


def _slstm_recur(p: dict, xw: torch.Tensor, chunked: bool):
    """The recurrence over ``xw [B,S,4D]`` from the zero carry, on each
    rank's rows when it is a DTensor (``on_shards``; ``r`` and ``bias``
    whole on every rank, their gradients summed over the ranks that split
    the rows), in one pass or, with ``chunked``, in checkpointed chunks of
    ``_pick_chunk(S)`` steps: ``(h [B,S,D], (h, c, n, m))``, the carry
    ``[B, D]`` each."""
    B, S = xw.shape[:2]
    D = p["w_dn"].shape[0]
    (xw,), wrap = on_shards((xw,), (0,))
    pl = wrap.params({"r": p["r"], "bias": p["bias"]})
    carry = tuple(torch.zeros((xw.shape[0], D), dtype=torch.float32,
                              device=xw.device) for _ in range(4))
    if not chunked:
        h, *carry = _slstm_scan(pl, xw, *carry)
    else:
        Ck = _pick_chunk(S)
        hs = []
        for j in range(steps("slstm.chunks", S // Ck)):
            i = j * Ck
            h, *carry = checkpoint(_slstm_scan, pl, xw[:, i:i + Ck],
                                   *carry, within="slstm.chunks",
                                   use_reentrant=False)
            hs.append(h)
        h = cat_chunks(hs, S // Ck)
    return wrap(h, (B, S, D)), tuple(wrap(t, (B, D)) for t in carry)


def apply_slstm(p: dict, x: torch.Tensor, return_state: bool = False):
    """Prefill: ``x [B,S,D] -> [B,S,D]``, sequential over S (on DTensors,
    on each rank's rows); with ``return_state`` also the carry ``{"h",
    "c", "n", "m"}`` (each ``[B, D]`` float32)."""
    h, carry = _slstm_recur(p, x @ p["w"], chunked=False)
    out = h.to(x.dtype) @ p["w_dn"]
    if not return_state:
        return out
    return out, dict(zip(("h", "c", "n", "m"), carry))


def apply_slstm_train(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Training: ``x [B,S,D] -> [B,S,D]``, differentiable; the recurrence
    in checkpointed chunks of ``_pick_chunk(S)`` steps (on DTensors, on
    each rank's rows)."""
    h, _ = _slstm_recur(p, x @ p["w"], chunked=True)
    return h.to(x.dtype) @ p["w_dn"]


def slstm_state_init(batch: int, p: dict) -> dict:
    """Zeroed carry of one sLSTM layer (``m`` 0, as the reference's)."""
    d = p["w_dn"].shape[0]
    return {k: torch.zeros((batch, d), dtype=torch.float32,
                           device=p["w"].device) for k in ("h", "c", "n", "m")}


def slstm_decode_step(p: dict, x: torch.Tensor, state: dict
                      ) -> tuple[torch.Tensor, dict]:
    """One token ``x [B,1,D]`` -> ``(y [B,1,D], new state)``."""
    carry = (state["h"], state["c"], state["n"], state["m"])
    h, c, n, m = _slstm_step(p, x[:, 0] @ p["w"], carry)
    y = h.to(x.dtype) @ p["w_dn"]
    return y[:, None], {"h": h, "c": c, "n": n, "m": m}
