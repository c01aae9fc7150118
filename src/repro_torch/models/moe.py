"""Mixture-of-Experts feed-forward: top-k router + sort-based capacity
dispatch.

Counterpart of ``repro.models.moe.apply_moe``. Each batch row is one
dispatch group: its ``T * k`` (token, choice) assignments are sorted by
expert (stable, so within an expert in token-then-choice order), ranked
within their expert's run, and those with ``rank < C`` are scattered into an
``[E, C, D]`` buffer; the rest are dropped (they contribute zero). The
capacity is ``C = int(ceil(T * k / E) * capacity_factor)`` (at least 1), or
``C = T`` with ``dropless`` — the reference's inference setting, which its
prefill and decode pass and which makes them route a token the same way.

The top-k picks the larger probability first and, on a tie, the lower
expert id, as ``jax.lax.top_k`` does (a stable descending sort; ``torch.
topk`` does not promise an order on ties). Parameters: ``wr [d, E]``,
``wg`` / ``wu [E, d, F]``, ``wd [E, F, d]``, and with
``n_shared_experts`` a ``shared`` SwiGLU MLP of width ``F *
n_shared_experts`` (``wg`` / ``wu [d, F*n]``, ``wd [F*n, d]``) that every
token passes through beside its routed experts, as the reference's.
:func:`apply_moe_dense_ref` is the reference's per-token oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.activations import on_shards

from .layers import activation, apply_mlp


def router(x: torch.Tensor, wr: torch.Tensor, top_k: int):
    """x [T,D] -> (weights [T,k] f32 renormalised over k, ids [T,k] int64,
    Switch aux loss)."""
    logits = (x @ wr).float()                                # [T,E]
    probs = torch.softmax(logits, -1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    E = wr.shape[1]
    hot = F.one_hot(ids[:, 0], E).float()
    aux = E * torch.sum(hot.mean(0) * probs.mean(0))
    return w, ids, aux


def capacity(S: int, top_k: int, n_experts: int, capacity_factor: float,
             dropless: bool) -> int:
    """Slots per expert per group of ``S`` tokens."""
    if dropless:
        return S
    return max(1, int(-(-S * top_k // n_experts) * capacity_factor))


def dispatch_plan(ids: torch.Tensor, n_experts: int, C: int):
    """Integer routing of every group, ``ids [G,T,k]`` -> ``(order, rank,
    keep, dest)``, each ``[G, T*k]`` over the assignments in expert-sorted
    order: ``order`` the stable sort of the flat (token, choice) index by
    expert, ``rank`` the slot within the expert, ``keep = rank < C``,
    ``dest`` the buffer row (``E*C``, a dustbin row, for a drop)."""
    G = ids.shape[0]
    e_flat = ids.reshape(G, -1)
    order = torch.argsort(e_flat, dim=1, stable=True)
    es = torch.gather(e_flat, 1, order)
    counts = torch.zeros((G, n_experts), dtype=es.dtype,
                         device=es.device).scatter_add(
        1, es, torch.ones_like(es))
    starts = torch.cumsum(counts, 1) - counts
    rank = (torch.arange(es.shape[1], device=es.device)[None]
            - torch.gather(starts, 1, es))
    keep = rank < C
    dest = torch.where(keep, es * C + rank,
                       torch.full_like(rank, n_experts * C))
    return order, rank, keep, dest


def _shared(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    s = p["shared"]
    return apply_mlp(s["wg"], s["wu"], s["wd"], x, act)


def _expert_products(eb: torch.Tensor, p: dict, f, B: int, E: int, C: int,
                     D: int) -> torch.Tensor:
    """The experts on their buffer rows ``eb [B, E*C, D]`` -> ``[B, E*C,
    D]``: each expert's rows of every group as one contiguous ``[E, B*C,
    D]`` operand, then ``f(x wg) * (x wu)`` and its ``wd`` as batched
    products over the experts. Contiguous operands and ``reshape`` (never
    a view across a permute) keep one form for plain tensors and for
    DTensors, whose local shards an ``einsum``'s internal views refuse."""
    xe = eb.reshape(B, E, C, D).permute(1, 0, 2, 3).contiguous() \
        .reshape(E, B * C, D)
    h = f(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    y = torch.bmm(h, p["wd"]).reshape(E, B, C, D)
    return y.permute(1, 0, 2, 3).contiguous().reshape(B, E * C, D)


def apply_moe(p: dict, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu",
              dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (y [B,S,D], aux loss), one dispatch group per row;
    plus the shared expert's MLP of ``x`` where ``p`` has one. ``act``:
    ``"silu"`` (SwiGLU experts) or ``"gelu"`` (GeGLU, tanh form)."""
    f = activation(act)
    B, S, D = x.shape
    E = p["wr"].shape[1]
    w, ids, aux = router(x.reshape(B * S, D), p["wr"], top_k)
    C = capacity(S, top_k, E, capacity_factor, dropless)
    order, _, _, dest = dispatch_plan(ids.reshape(B, S, top_k), E, C)
    # the scatter into the buffers and the gather back run on each rank's
    # groups (on DTensors: on_shards), as the reference vmaps a group
    (xg, order, dest), wrap = on_shards((x, order, dest), (0,))
    b = xg.shape[0]
    rows = torch.arange(b, device=xg.device)[:, None]
    toks = torch.div(order, top_k, rounding_mode="floor")
    # every group's buffer in one [B, E*C + 1, D] tensor, so one product
    # per weight reads each expert's weights once for the whole batch
    buf = torch.zeros((b, E * C + 1, D), dtype=x.dtype,
                      device=xg.device).index_put((rows, dest), xg[rows, toks])
    buf = wrap(buf, (B, E * C + 1, D))
    y_e = wrap.local(_expert_products(buf[:, :E * C], p, f, B, E, C, D))
    y_e = torch.cat([y_e, torch.zeros((b, 1, D), dtype=y_e.dtype,
                                      device=y_e.device)], 1)
    y_sorted = y_e[rows, dest]                               # [b, S*k, D]
    y_tok = torch.empty_like(y_sorted).index_put(            # token order
        (rows, order), y_sorted).reshape(b, S, top_k, D)
    y_tok = wrap(y_tok, (B, S, top_k, D))
    wk = w.reshape(B, S, top_k, 1).to(y_tok.dtype)
    y = torch.sum(y_tok * wk, dim=2)
    if "shared" in p:
        y = y + _shared(p, x, act)
    return y, aux


def apply_moe_dense_ref(p: dict, x: torch.Tensor, top_k: int,
                        act: str = "silu") -> torch.Tensor:
    """Oracle: each token's top-k experts applied through per-token weight
    gathers, no capacity and no drops, plus the shared expert. O(T*k*D*F)
    weight bytes gathered: for small test configs only; no serve path
    calls it."""
    f = activation(act)
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    w, ids, _ = router(xf, p["wr"], top_k)

    def per_k(j):
        e = ids[:, j]
        wg, wu, wd = p["wg"][e], p["wu"][e], p["wd"][e]
        h = f(torch.einsum("td,tdf->tf", xf, wg)) \
            * torch.einsum("td,tdf->tf", xf, wu)
        return torch.einsum("tf,tfd->td", h, wd) * w[:, j, None].to(x.dtype)

    y = sum(per_k(j) for j in range(top_k))
    if "shared" in p:
        y = y + _shared(p, xf, act)
    return y.reshape(B, S, D)
