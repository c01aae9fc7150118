"""Leap controller in PyTorch: history, FINDTREND, window and the fused step.

Counterparts of the jnp twins of the reference:

* ``core/history.py`` — :func:`init_history`, :func:`push_history`,
  :func:`history_window_gather`;
* ``core/trend.py`` — :func:`_masked_boyer_moore`, :func:`trend_ladder`,
  :func:`find_trend`;
* ``core/window.py`` — :func:`_round_up_pow2`, :func:`next_window_size`,
  :func:`note_prefetch_hits`;
* ``core/leap_jax.py`` — :func:`leap_init`, :func:`leap_step`,
  :func:`leap_step_batched`.

Every function works on any leading batch shape (``vmap`` in the reference
becomes an explicit leading stream dimension here), keeps every state leaf
int32 / bool as the reference does, and is bit-exact to it. Functions
return new tensors; none updates its inputs in place.

:func:`_masked_boyer_moore` is the reference's sequential vote, one step
per history entry; it is the oracle the tests hold :func:`trend_ladder`
against, rung by rung. :func:`trend_ladder` does not run it: a rung's result
is used only when its vote verifies, and a verified Boyer–Moore candidate
is exactly the window's strict majority, the one value held by more than
half of the window. The ladder therefore counts, for every rung at once,
how often each entry's value occurs in the window and takes the most
frequent one — the same ``(delta, found)`` as the reference's ladder in a
fixed dozen tensor ops instead of ``h_size`` sequential steps per rung
(the controller runs once per page access, so its op count is the
control plane's launch count on the GPU).
"""

from __future__ import annotations

import torch

from repro_torch.device import cached_arange, resolve_device

DEFAULT_H_SIZE = 32
DEFAULT_N_SPLIT = 8
DEFAULT_PW_MAX = 8

I32 = torch.int32


# --------------------------------------------------------------------------
# history (core/history.py)
# --------------------------------------------------------------------------
def init_history(h_size: int = DEFAULT_H_SIZE, batch: tuple[int, ...] = (),
                 device=None) -> dict:
    """Fixed-shape history state, optionally batched over leading dims."""
    dev = resolve_device(device)
    z = lambda shape, dt: torch.zeros(batch + shape, dtype=dt, device=dev)
    return {
        "deltas": z((h_size,), I32),
        "head": z((), I32) - 1,
        "count": z((), I32),
        "last_page": z((), I32),
        "has_last": z((), torch.bool),
    }


def push_history(state: dict, page: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Record one access per stream; returns ``(state, delta)``."""
    deltas = state["deltas"]
    h_size = deltas.shape[-1]
    page = page.to(I32)
    delta = torch.where(state["has_last"], page - state["last_page"],
                        torch.zeros_like(page))
    head = torch.remainder(state["head"] + 1, h_size)
    ar = cached_arange(h_size, deltas.device)
    new = {
        "deltas": torch.where(ar == head[..., None], delta[..., None], deltas),
        "head": head,
        "count": torch.clamp(state["count"] + 1, max=h_size),
        "last_page": page,
        "has_last": torch.ones_like(state["has_last"]),
    }
    return new, delta


def history_window_gather(state: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """``(deltas newest-first over the full ring, validity mask)``."""
    deltas = state["deltas"]
    h_size = deltas.shape[-1]
    ar = cached_arange(h_size, deltas.device)
    idx = torch.remainder(state["head"][..., None] - ar, h_size)
    vals = torch.gather(deltas, -1, idx.long())
    mask = ar < state["count"][..., None]
    return vals, mask


# --------------------------------------------------------------------------
# FINDTREND (core/trend.py)
# --------------------------------------------------------------------------
def _masked_boyer_moore(vals: torch.Tensor, mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Vote + verify over the last dim of ``vals`` where ``mask`` selects
    window members; any leading shape. Returns ``(candidate, found)``."""
    cand = torch.zeros(vals.shape[:-1], dtype=I32, device=vals.device)
    votes = torch.zeros_like(cand)
    one = torch.ones_like(cand)
    for i in range(vals.shape[-1]):
        x, m = vals[..., i], mask[..., i]
        is_zero = votes == 0
        new_cand = torch.where(is_zero, x, cand)
        new_votes = torch.where(is_zero, one,
                                torch.where(x == cand, votes + 1, votes - 1))
        cand = torch.where(m, new_cand, cand)
        votes = torch.where(m, new_votes, votes)
    n = mask.sum(-1, dtype=I32)
    count = (mask & (vals == cand[..., None])).sum(-1, dtype=I32)
    found = (n > 0) & (count >= torch.div(n, 2, rounding_mode="floor") + 1)
    return cand, found


def _rung_widths(h_size: int, n_split: int) -> list[int]:
    widths, w = [], max(1, h_size // n_split)
    while True:
        widths.append(w)
        if w >= h_size:
            return widths
        w = min(w * 2, h_size)


_RUNGS: dict = {}


def _rung_masks(h_size: int, n_split: int, device) -> torch.Tensor:
    """``bool[R, h_size]``: entry i is in rung r's window (built once)."""
    key = (h_size, n_split, torch.device(device))
    m = _RUNGS.get(key)
    if m is None:
        w = torch.tensor(_rung_widths(h_size, n_split))
        m = torch.arange(h_size)[None, :] < w[:, None]
        m = _RUNGS[key] = m.to(device)
    return m


def trend_ladder(vals: torch.Tensor, valid: torch.Tensor, n_split: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Doubling-window ladder over newest-first deltas ``[..., H]``.

    The first rung with a strict majority wins; the last rung clamps to the
    full history, as in the reference. Each rung's majority is found by
    counting (see the module docstring), equal to the reference's verified
    Boyer–Moore vote.
    """
    h_size = vals.shape[-1]
    rungs = _rung_masks(h_size, n_split, vals.device)          # [R, H]
    masks = rungs & valid[..., None, :]                        # [..., R, H]
    same = vals[..., :, None] == vals[..., None, :]            # [..., H, H]
    # occurrences of entry i's value among rung r's members, i a member
    occ = (masks[..., :, None, :] & same[..., None, :, :]).sum(-1)
    occ = torch.where(masks, occ, torch.zeros_like(occ))
    top = torch.argmax(occ, dim=-1)                            # [..., R]
    n = masks.sum(-1)
    founds = (n > 0) & (occ.amax(-1) >= torch.div(n, 2,
                                                  rounding_mode="floor") + 1)
    cands = torch.gather(vals[..., None, :].expand(masks.shape), -1,
                         top[..., None])[..., 0]
    best_delta = torch.zeros(vals.shape[:-1], dtype=I32, device=vals.device)
    best_found = torch.zeros(vals.shape[:-1], dtype=torch.bool,
                             device=vals.device)
    for r in range(rungs.shape[0]):
        take = founds[..., r] & ~best_found
        best_delta = torch.where(take, cands[..., r], best_delta)
        best_found = best_found | founds[..., r]
    return best_delta, best_found


def find_trend(state: dict, n_split: int = DEFAULT_N_SPLIT
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """FINDTREND over a history state (the reference's ``find_trend_jax``)."""
    vals, valid = history_window_gather(state)
    return trend_ladder(vals, valid, n_split)


# --------------------------------------------------------------------------
# window (core/window.py)
# --------------------------------------------------------------------------
def _round_up_pow2(x: torch.Tensor) -> torch.Tensor:
    """Smallest power of two >= x, elementwise, for int32 x >= 1."""
    y = torch.clamp(x - 1, min=0)
    for shift in (1, 2, 4, 8, 16):
        y = y | (y >> shift)
    return torch.clamp(y + 1, min=1)


def next_window_size(state: dict, follows_trend: torch.Tensor,
                     pw_max: int = DEFAULT_PW_MAX) -> tuple[dict, torch.Tensor]:
    """Alg. 2 GetPrefetchWindowSize over ``{"pw_prev", "c_hit"}``."""
    c_hit, pw_prev = state["c_hit"], state["pw_prev"]
    cold = follows_trend.to(I32)
    grown = torch.clamp(_round_up_pow2(c_hit + 1), max=pw_max)
    half = torch.div(pw_prev, 2, rounding_mode="floor")
    grown = torch.where(grown < half, half, grown)
    pw = torch.where(c_hit == 0, cold, grown).to(I32)
    return {"pw_prev": pw, "c_hit": torch.zeros_like(c_hit)}, pw


def note_prefetch_hits(state: dict, hits: torch.Tensor) -> dict:
    """Accumulate prefetched-cache hits observed since the last prefetch."""
    return {"pw_prev": state["pw_prev"],
            "c_hit": state["c_hit"] + hits.to(I32)}


# --------------------------------------------------------------------------
# fused controller (core/leap_jax.py)
# --------------------------------------------------------------------------
def leap_init(h_size: int = DEFAULT_H_SIZE, batch: tuple[int, ...] = (),
              device=None) -> dict:
    """Fresh controller state, optionally batched over leading dims."""
    state = init_history(h_size, batch, device)
    dev = state["deltas"].device
    z = lambda dt: torch.zeros(batch, dtype=dt, device=dev)
    state.update(pw_prev=z(I32), c_hit=z(I32), trend=z(I32),
                 has_trend=z(torch.bool))
    return state


def leap_step(state: dict, page: torch.Tensor, prefetched_hit: torch.Tensor,
              n_split: int = DEFAULT_N_SPLIT, pw_max: int = DEFAULT_PW_MAX
              ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """One fault per stream through the controller.

    ``page`` / ``prefetched_hit`` have the state's batch shape. Returns
    ``(state, candidates [..., pw_max], valid [..., pw_max])`` with
    ``candidates[k] = page + step * (k + 1)`` and ``valid`` masking the
    first ``PW_size`` (all False while prefetching is suspended).
    """
    state = dict(state)
    state["c_hit"] = state["c_hit"] + prefetched_hit.to(I32)
    hist = {k: state[k] for k in ("deltas", "head", "count", "last_page",
                                  "has_last")}
    hist, delta = push_history(hist, page)
    state.update(hist)

    trend, found = find_trend(state, n_split)
    cur_trend = torch.where(found, trend, state["trend"])
    has_trend = state["has_trend"] | found

    follows = has_trend & (delta == cur_trend)
    win, pw = next_window_size(state, follows, pw_max)
    state["pw_prev"] = win["pw_prev"]
    state["c_hit"] = win["c_hit"]
    state["trend"] = cur_trend
    state["has_trend"] = has_trend

    step = torch.where(found, trend, cur_trend)
    can = (pw > 0) & has_trend & (step != 0)
    ks = cached_arange(pw_max, page.device, start=1)
    candidates = page.to(I32)[..., None] + step[..., None] * ks
    valid = can[..., None] & (ks <= pw[..., None])
    return state, candidates, valid


def leap_step_batched(state: dict, pages: torch.Tensor,
                      prefetched_hits: torch.Tensor,
                      n_split: int = DEFAULT_N_SPLIT,
                      pw_max: int = DEFAULT_PW_MAX):
    """:func:`leap_step` over a leading ``[streams]`` dim (it already
    broadcasts over any batch shape; kept for the reference's name)."""
    return leap_step(state, pages, prefetched_hits, n_split, pw_max)
