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
``wg`` / ``wu [E, d, F]``, ``wd [E, F, d]``. A shared expert
(``n_shared_experts``) is not ported: the hybrid family has none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    counts = torch.zeros((G, n_experts), dtype=es.dtype, device=es.device)
    counts.scatter_add_(1, es, torch.ones_like(es))
    starts = torch.cumsum(counts, 1) - counts
    rank = (torch.arange(es.shape[1], device=es.device)[None]
            - torch.gather(starts, 1, es))
    keep = rank < C
    dest = torch.where(keep, es * C + rank,
                       torch.full_like(rank, n_experts * C))
    return order, rank, keep, dest


def apply_moe(p: dict, x: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, act: str = "silu",
              dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (y [B,S,D], aux loss), one dispatch group per row."""
    if act != "silu":
        raise NotImplementedError(f"MoE act={act!r} is ported with the "
                                  "families that use it (ROADMAP queue 1 "
                                  "item 3)")
    B, S, D = x.shape
    E = p["wr"].shape[1]
    w, ids, aux = router(x.reshape(B * S, D), p["wr"], top_k)
    C = capacity(S, top_k, E, capacity_factor, dropless)
    order, _, _, dest = dispatch_plan(ids.reshape(B, S, top_k), E, C)
    # every group's buffer in one [B, E*C + 1, D] tensor, so one product
    # per weight reads each expert's weights once for the whole batch
    rows = torch.arange(B, device=x.device)[:, None]
    toks = torch.div(order, top_k, rounding_mode="floor")
    buf = torch.zeros((B, E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[rows, dest] = x[rows, toks]
    eb = buf[:, :E * C].reshape(B, E, C, D)
    h = F.silu(torch.einsum("becd,edf->becf", eb, p["wg"])) \
        * torch.einsum("becd,edf->becf", eb, p["wu"])
    y_e = torch.einsum("becf,efd->becd", h, p["wd"]).reshape(B, E * C, D)
    y_e = torch.cat([y_e, torch.zeros((B, 1, D), dtype=y_e.dtype,
                                      device=y_e.device)], 1)
    y_sorted = y_e[rows, dest]                               # [B, S*k, D]
    y_tok = torch.empty_like(y_sorted)
    y_tok[rows, order] = y_sorted                            # token order
    y_tok = y_tok.reshape(B, S, top_k, D)
    wk = w.reshape(B, S, top_k, 1).to(y_tok.dtype)
    return torch.sum(y_tok * wk, dim=2), aux
