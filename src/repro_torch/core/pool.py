"""Two-tier paged pool metadata in PyTorch, batched over streams.

Counterpart of ``src/repro/core/pool.py`` for the tiered path's
metadata-only transactions (the caller moves the bytes itself from the
returned copy plan, through the gather kernels). Every state leaf carries
an explicit leading stream dimension ``[S, ...]`` — the reference vmaps the
same per-stream functions — and stays int32 / bool so the state dicts
compare exactly with the reference's. The per-request loops of the
reference's ``lax.scan`` / ``fori_loop`` are Python loops here, each
iteration a handful of whole-``[S, n]`` selects, so the cost does not grow
with the stream count.

Indexing follows the reference: gathers clamp their index into range (as
jnp indexing does), and a single-element update is a one-hot select, so a
masked-out update is simply not applied. Functions return new state dicts
and never modify their inputs.

**Payloads** are a tensor or a dict of tensors: ``hot`` leaves are
``[S, n_slots, ...]`` (each stream's own hot buffer) and ``pool`` leaves
``[n_pages, ...]`` (one slow tier every stream reads). The leaves of one
slot always move together. ``None`` for both is the metadata-only mode:
the caller applies the returned copy plan itself, as the tiered sweep does
through the gather kernels. Payload writes return new tensors too.

The ``tier_*`` transactions of the three-tier lifecycle (DESIGN.md §12)
carry no stream dim: one table of ``[n_pages]`` leaves (home shard,
compressed bit, heat, last transition) that every stream shares, as in the
reference. The reference's ``mode="drop"`` scatters write into one extra
column that is then cut off.
"""

from __future__ import annotations

import torch

from repro_torch.device import cached_arange, resolve_device

NO_PAGE = -1
NO_SLOT = -1
PLACEMENTS = ("block", "interleave")
I32 = torch.int32
_INT32_MAX = 2 ** 31 - 1


# ---- home-shard metadata ----------------------------------------------------
def page_home(pages: torch.Tensor, n_pages: int, n_shards: int,
              placement: str) -> torch.Tensor:
    """Home shard of each page id (invalid ids map to their clamped value)."""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, "
                         f"got {placement!r}")
    p = pages.clamp(0, n_pages - 1)
    if placement == "interleave":
        return torch.remainder(p, n_shards).to(I32)
    return torch.div(p, n_pages // n_shards, rounding_mode="floor").to(I32)


def page_local(pages: torch.Tensor, n_pages: int, n_shards: int,
               placement: str) -> torch.Tensor:
    """Index of each page within its home shard's ``[pps, ...]`` slice."""
    if placement not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, "
                         f"got {placement!r}")
    p = pages.clamp(0, n_pages - 1)
    if placement == "interleave":
        return torch.div(p, n_shards, rounding_mode="floor").to(I32)
    return torch.remainder(p, n_pages // n_shards).to(I32)


# ---- three-tier residency lifecycle (DESIGN.md §12) -------------------------
#: ``last_mig`` at init: the cooldown gate is open at t = 0 and ``t -
#: last_mig`` never overflows int32
_TIER_NEVER = -(1 << 30)


def tier_init(n_pages: int, n_shards: int, placement: str,
              device=None) -> dict:
    """Lifecycle tables: ``home int32[n_pages]`` (seeded from the static
    placement), ``comp bool`` (True = in the compressed cold tier), ``heat
    int32`` (decayed access heat), ``last_mig int32`` (step of the last
    tier transition) and 0-dim int32 counters ``n_migrations`` /
    ``n_demotions`` / ``n_promotions``."""
    dev = resolve_device(device)
    pages = torch.arange(n_pages, dtype=I32, device=dev)
    zero = lambda: torch.zeros((), dtype=I32, device=dev)
    return {
        "home": page_home(pages, n_pages, n_shards, placement),
        "comp": torch.zeros((n_pages,), dtype=torch.bool, device=dev),
        "heat": torch.zeros((n_pages,), dtype=I32, device=dev),
        "last_mig": torch.full((n_pages,), _TIER_NEVER, dtype=I32,
                               device=dev),
        "n_migrations": zero(),
        "n_demotions": zero(),
        "n_promotions": zero(),
    }


def _tier_scatter_idx(tier: dict, pages: torch.Tensor,
                      ok: torch.Tensor) -> torch.Tensor:
    """Scatter index with invalid entries sent to the drop column
    ``n_pages``."""
    n_pages = tier["home"].shape[0]
    return torch.where(ok, pages.clamp(0, n_pages - 1),
                       torch.full_like(pages, n_pages)).long()


def _tier_set(a: torch.Tensor, idx: torch.Tensor, v) -> torch.Tensor:
    """``a`` with ``a[idx] = v`` (a new tensor); ``idx == len(a)`` drops."""
    ext = torch.cat([a, a.new_zeros((1,))])
    v = torch.as_tensor(v, dtype=a.dtype, device=a.device).expand(idx.shape)
    return ext.index_put_((idx,), v)[:-1]


def tier_migrate(tier: dict, pages: torch.Tensor, dests: torch.Tensor,
                 ok: torch.Tensor, now) -> dict:
    """Re-home granted migrations and stamp the cooldown clock. Callers
    deduplicate same-step proposals for one page (lowest ``seq`` wins)."""
    idx = _tier_scatter_idx(tier, pages, ok)
    tier = dict(tier)
    tier["home"] = _tier_set(tier["home"], idx, dests.to(I32))
    tier["last_mig"] = _tier_set(tier["last_mig"], idx, now)
    tier["n_migrations"] = tier["n_migrations"] + _i(ok).sum(dtype=I32)
    return tier


def tier_demote(tier: dict, pages: torch.Tensor, ok: torch.Tensor,
                now) -> dict:
    """Move cold pages into the compressed tier (metadata; the caller
    round-trips the bytes through the page codec). ``pages`` are distinct
    where ``ok``."""
    idx = _tier_scatter_idx(tier, pages, ok)
    tier = dict(tier)
    tier["comp"] = _tier_set(tier["comp"], idx, True)
    tier["last_mig"] = _tier_set(tier["last_mig"], idx, now)
    tier["n_demotions"] = tier["n_demotions"] + _i(ok).sum(dtype=I32)
    return tier


def tier_promote(tier: dict, pages: torch.Tensor, ok: torch.Tensor,
                 comp_pre: torch.Tensor | None = None
                 ) -> tuple[dict, torch.Tensor]:
    """Clear the compressed bit on pages whose bytes just moved hot-ward.
    Promotions count against ``comp_pre``, the start-of-step snapshot of
    ``tier["comp"]`` (``None``: the current table), so two streams moving
    one compressed page in a step each count one. Returns ``(tier,
    n_promoted)``."""
    if comp_pre is None:
        comp_pre = tier["comp"]
    n_pages = tier["home"].shape[0]
    promoted = ok & comp_pre[pages.clamp(0, n_pages - 1).long()]
    idx = _tier_scatter_idx(tier, pages, ok)
    tier = dict(tier)
    tier["comp"] = _tier_set(tier["comp"], idx, False)
    n_new = _i(promoted).sum(dtype=I32)
    tier["n_promotions"] = tier["n_promotions"] + n_new
    return tier, n_new


def tier_heat_decay(tier: dict) -> dict:
    """One step of heat decay, ``(heat * 3) >> 2`` on int32 (it drains to
    0, and equals the Python-int form the host mirror uses)."""
    tier = dict(tier)
    tier["heat"] = (tier["heat"] * 3) >> 2
    return tier


def tier_touch(tier: dict, pages: torch.Tensor, ok: torch.Tensor,
               amount: int) -> dict:
    """Add ``amount`` heat to each touched page (duplicates accumulate)."""
    idx = _tier_scatter_idx(tier, pages, ok).reshape(-1)
    heat = tier["heat"]
    ext = torch.cat([heat, heat.new_zeros((1,))])
    ext = ext.index_add(0, idx, torch.full(idx.shape, amount, dtype=I32,
                                           device=heat.device))
    tier = dict(tier)
    tier["heat"] = ext[:-1]
    return tier


def tier_stats(tier: dict) -> dict:
    """Host-side residency summary of the lifecycle tables."""
    comp = tier["comp"]
    return {
        "n_pages": int(comp.shape[0]),
        "uncompressed": int((~comp).sum()),
        "compressed": int(comp.sum()),
        "migrations": int(tier["n_migrations"]),
        "demotions": int(tier["n_demotions"]),
        "promotions": int(tier["n_promotions"]),
    }


# ---- state -----------------------------------------------------------------
def pool_init(n_pages: int, n_slots: int, n_streams: int = 1,
              device=None) -> dict:
    """Metadata of ``n_streams`` pools of ``n_pages`` cached by ``n_slots``
    hot slots each (the reference's ``pool_init`` with a leading stream
    dim)."""
    dev = resolve_device(device)
    S = n_streams
    full = lambda n, v: torch.full((S, n), v, dtype=I32, device=dev)
    zeros = lambda: torch.zeros((S,), dtype=I32, device=dev)
    st = {
        "page_slot": full(n_pages, NO_SLOT),
        "slot_page": full(n_slots, NO_PAGE),
        "slot_prefetched": torch.zeros((S, n_slots), dtype=torch.bool,
                                       device=dev),
        "slot_consumed": torch.zeros((S, n_slots), dtype=torch.bool,
                                     device=dev),
        "slot_last_use": full(n_slots, 0),
        "free_stack": torch.arange(n_slots - 1, -1, -1, dtype=I32,
                                   device=dev).repeat(S, 1),
        "free_top": zeros() + n_slots,
        "fifo": full(n_slots, NO_SLOT),
        "fifo_head": zeros(),
        "fifo_count": zeros(),
        "clock": zeros(),
    }
    for k in ("n_hits", "n_misses", "n_prefetch_issued", "n_prefetch_hits",
              "n_pollution", "n_alloc_scans", "n_partial_hits", "n_deferred"):
        st[k] = zeros()
    return st


def ring_init(capacity: int, n_streams: int = 1, device=None) -> dict:
    """In-flight rings of the async issue/wait path, one per stream."""
    dev = resolve_device(device)
    S = n_streams
    zeros = lambda: torch.zeros((S, capacity), dtype=I32, device=dev)
    return {
        "page": torch.full((S, capacity), NO_PAGE, dtype=I32, device=dev),
        "ready": zeros(),
        "deadline": zeros(),
        "issued_at": zeros(),
        "seq": zeros(),
        "now": torch.zeros((S,), dtype=I32, device=dev),
        "n_drops": torch.zeros((S,), dtype=I32, device=dev),
    }


# ---- batched element helpers -------------------------------------------------
def _get(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[s, i[s]]`` for every stream, the index clamped into range."""
    idx = i.clamp(0, a.shape[1] - 1).long()
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _set(a: torch.Tensor, i: torch.Tensor, v, cond=None) -> torch.Tensor:
    """``a`` with ``a[s, i[s]] = v[s]`` where ``cond[s]`` (one-hot select:
    an out-of-range index updates nothing). ``v`` is ``[S]`` or a scalar."""
    hit = cached_arange(a.shape[1], a.device)[None, :] == i[:, None]
    if cond is not None:
        hit = hit & cond[:, None]
    if isinstance(v, torch.Tensor):
        v = v.to(a.dtype)[:, None]
    return torch.where(hit, v, a)


def _where(cond: torch.Tensor, on_true: dict, on_false: dict) -> dict:
    """Per-stream select between two structurally identical state dicts."""
    out = {}
    for k, a in on_false.items():
        b = on_true[k]
        if b is a:               # leaf untouched on both sides: no select
            out[k] = a
            continue
        c = cond.reshape(cond.shape + (1,) * (a.dim() - 1))
        out[k] = torch.where(c, b, a)
    return out


def _i(x: torch.Tensor) -> torch.Tensor:
    return x.to(I32)


# ---- payload helpers (reference :464-481) -----------------------------------
# ``None`` is the metadata-only mode: every helper passes it through.
def _tree_map(fn, *trees):
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def _payload_page(pool, page: torch.Tensor):
    """Each stream's page ``page [S]`` from every leaf of the slow tier
    (leaves ``[S, ...]``; the index clamped into range, as jnp gathers)."""
    return _tree_map(
        lambda p: p[page.clamp(0, p.shape[0] - 1).long()], pool)


def _payload_store(hot, slot: torch.Tensor, val):
    """``hot`` with each stream's slot ``slot [S]`` set to ``val`` across
    every leaf (new tensors)."""
    def one(h, v):
        h = h.clone()
        h[cached_arange(h.shape[0], h.device).long(), slot.long()] = v.to(
            h.dtype)
        return h
    return _tree_map(one, hot, val)


def _payload_where(cond: torch.Tensor, on_true, on_false):
    """Per-stream select between two payloads of the same structure."""
    return _tree_map(
        lambda b, a: torch.where(
            cond.reshape(cond.shape + (1,) * (a.dim() - 1)), b, a),
        on_true, on_false)


def _payload_slots(hot, slot: torch.Tensor):
    """``hot[s, slot[s]]`` for every stream (``slot`` clamped to >= 0)."""
    return _tree_map(
        lambda h: h[cached_arange(h.shape[0], h.device).long(),
                    slot.clamp(min=0).long()], hot)


# ---- private helpers (reference :359-516) ------------------------------------
def _free_push(st: dict, slot: torch.Tensor, cond=None) -> dict:
    st = dict(st)
    st["free_stack"] = _set(st["free_stack"], st["free_top"], slot, cond)
    inc = 1 if cond is None else _i(cond)
    st["free_top"] = st["free_top"] + inc
    return st


def _fifo_pop_oldest_valid(st: dict) -> tuple[dict, torch.Tensor]:
    """Pop each stream's oldest FIFO entry that is still an unconsumed
    prefetch (stale entries are skipped for free)."""
    fifo = st["fifo"]
    n = fifo.shape[1]
    ar = cached_arange(n, fifo.device)
    order = torch.remainder(st["fifo_head"][:, None] + ar, n)
    slots = torch.gather(fifo, 1, order.long())
    safe = slots.clamp(min=0).long()
    live = ((slots >= 0)
            & (torch.gather(st["slot_page"], 1, safe) >= 0)
            & torch.gather(st["slot_prefetched"], 1, safe)
            & ~torch.gather(st["slot_consumed"], 1, safe)
            & (ar[None, :] < st["fifo_count"][:, None]))
    any_live = live.any(1)
    first = torch.argmax(live.to(I32), dim=1)          # first live entry
    victim = torch.where(any_live, torch.gather(slots, 1, first[:, None])[:, 0],
                         torch.full_like(any_live, NO_SLOT, dtype=I32))
    advance = torch.where(any_live, _i(first) + 1, st["fifo_count"])
    st = dict(st)
    st["fifo_head"] = torch.remainder(st["fifo_head"] + advance, n)
    st["fifo_count"] = st["fifo_count"] - advance
    return st, victim


def _evict_for_alloc(st: dict, lazy: bool) -> tuple[dict, torch.Tensor]:
    """Produce one victim slot per stream (used when the free stack is
    empty)."""
    if not lazy:
        st, victim = _fifo_pop_oldest_valid(st)
        victim = torch.where(victim >= 0, victim, torch.zeros_like(victim))
        st = dict(st)
        st["n_pollution"] = st["n_pollution"] + 1
        return st, victim
    st = dict(st)
    occupied = st["slot_page"] >= 0
    key = torch.where(occupied, st["slot_last_use"],
                      torch.full_like(st["slot_last_use"], _INT32_MAX))
    victim = _i(torch.argmin(key, dim=1))              # first minimum
    was_unconsumed = (_get(st["slot_prefetched"], victim)
                      & ~_get(st["slot_consumed"], victim))
    st["n_pollution"] = st["n_pollution"] + _i(was_unconsumed)
    st["n_alloc_scans"] = st["n_alloc_scans"] + st["slot_page"].shape[1]
    return st, victim


def _unmap(st: dict, slot: torch.Tensor) -> dict:
    st = dict(st)
    old_page = _get(st["slot_page"], slot)
    st["page_slot"] = _set(st["page_slot"], old_page.clamp(min=0), NO_SLOT,
                           old_page >= 0)
    st["slot_page"] = _set(st["slot_page"], slot, NO_PAGE)
    st["slot_prefetched"] = _set(st["slot_prefetched"], slot, False)
    st["slot_consumed"] = _set(st["slot_consumed"], slot, False)
    return st


def _check_batch_geometry(st: dict, K: int, lazy: bool, fn: str) -> None:
    """The per-batch hot-buffer floor, raised at call time: ``K`` slots
    (lazy LRU) or ``2*K`` (eager; deferred frees can pin a second K)."""
    n_slots = st["slot_page"].shape[-1]
    if lazy:
        need, why = f"K={K}", "the lazy LRU would re-evict same-batch slots"
    else:
        need = f"2*K={2 * K}"
        why = "a batch can pin 2*K slots (live + deferred eager frees)"
    if n_slots < (K if lazy else 2 * K):
        raise ValueError(
            f"{fn}: n_slots={n_slots} < {need} — {why}; "
            "size the hot buffer up or split the batch")


def _alloc_slot(st: dict, lazy: bool) -> tuple[dict, torch.Tensor]:
    """One free, unmapped slot per stream (stack pop, else evict)."""
    have_free = st["free_top"] > 0
    top_slot = _get(st["free_stack"], (st["free_top"] - 1).clamp(min=0))
    st_ev, victim = _evict_for_alloc(st, lazy)
    st_ev = _unmap(st_ev, victim)
    st = _where(~have_free, st_ev, st)
    slot = torch.where(have_free, top_slot, victim)
    st["free_top"] = torch.where(have_free, st["free_top"] - 1,
                                 st["free_top"])
    return st, slot


def _map_slot(st: dict, slot: torch.Tensor, page: torch.Tensor,
              pref: torch.Tensor) -> dict:
    """Map ``page`` into ``slot``; prefetches also enter the FIFO ring."""
    st = dict(st)
    st["page_slot"] = _set(st["page_slot"], page, slot)
    st["slot_page"] = _set(st["slot_page"], slot, page)
    st["slot_prefetched"] = _set(st["slot_prefetched"], slot, pref)
    st["slot_consumed"] = _set(st["slot_consumed"], slot, ~pref)
    st["slot_last_use"] = _set(st["slot_last_use"], slot, st["clock"])
    n = st["fifo"].shape[1]
    tail = torch.remainder(st["fifo_head"] + st["fifo_count"], n)
    st["fifo"] = _set(st["fifo"], tail, slot, pref)
    st["fifo_count"] = st["fifo_count"] + _i(pref)
    return st


# ---- transactions ------------------------------------------------------------
def pool_access(st: dict, hot, pool, pages: torch.Tensor,
                is_prefetch: torch.Tensor, valid: torch.Tensor,
                lazy: bool = False):
    """Service a batch of page requests ``[S, K]`` against the hot buffers.

    Returns ``(st, hot, slots [S, K], info)`` with per-request ``hit``,
    ``prefetched_hit`` and ``fetched`` masks, as the reference. With a
    payload, each fetched page's bytes land in its slot of ``hot``; slots
    eager-freed in the batch stay readable until the next call.
    """
    K = pages.shape[1]
    _check_batch_geometry(st, K, lazy, "pool_access")
    n_pages = st["page_slot"].shape[1]
    pages = pages.to(I32)
    outs = {"slot": [], "hit": [], "pref_hit": [], "fetched": [], "freed": []}
    for k in range(K):
        page, req_valid, pref = pages[:, k], valid[:, k], is_prefetch[:, k]
        st = dict(st)
        st["clock"] = st["clock"] + _i(req_valid)
        slot0 = _get(st["page_slot"], page.clamp(min=0))
        in_range = (page >= 0) & (page < n_pages)
        resident = req_valid & in_range & (slot0 >= 0)
        s_safe = slot0.clamp(min=0)
        was_pref_hit = (resident & ~pref & _get(st["slot_prefetched"], s_safe)
                        & ~_get(st["slot_consumed"], s_safe))
        demand_hit = resident & ~pref
        st["n_hits"] = st["n_hits"] + _i(demand_hit)
        st["n_prefetch_hits"] = st["n_prefetch_hits"] + _i(was_pref_hit)
        st["slot_consumed"] = _set(st["slot_consumed"], s_safe, True,
                                   demand_hit)
        st["slot_last_use"] = _set(st["slot_last_use"], s_safe, st["clock"],
                                   demand_hit)
        if not lazy:
            st = _where(was_pref_hit, _unmap(st, s_safe), st)

        need_fetch = req_valid & in_range & ~resident
        st_f, slot_new = _alloc_slot(st, lazy)
        st_m = _map_slot(st_f, slot_new, page, pref)
        st_m["n_prefetch_issued"] = st_m["n_prefetch_issued"] + _i(pref)
        st_m["n_misses"] = st_m["n_misses"] + _i(~pref)
        st = _where(need_fetch, st_m, st)
        hot = _payload_where(
            need_fetch,
            _payload_store(hot, slot_new,
                           _payload_page(pool, page.clamp(min=0))), hot)

        give_back = need_fetch & ~pref & (not lazy)
        if not lazy:
            st = _where(give_back, _unmap(st, slot_new), st)
        none = torch.full_like(slot0, NO_SLOT)
        freed = torch.where(was_pref_hit & (not lazy), s_safe,
                            torch.where(give_back, slot_new, none))
        out_slot = torch.where(resident, slot0,
                               torch.where(need_fetch, slot_new, none))
        outs["slot"].append(out_slot)
        outs["hit"].append(resident)
        outs["pref_hit"].append(was_pref_hit)
        outs["fetched"].append(need_fetch)
        outs["freed"].append(freed)
    for s in outs["freed"]:                      # deferred free-stack pushes
        st = _free_push(st, s.clamp(min=0), s >= 0)
    stack = lambda xs: torch.stack(xs, dim=1)
    return st, hot, stack(outs["slot"]), {
        "hit": stack(outs["hit"]), "prefetched_hit": stack(outs["pref_hit"]),
        "fetched": stack(outs["fetched"])}


def pool_issue(st: dict, ring: dict, pages: torch.Tensor, valid: torch.Tensor,
               now: torch.Tensor, delay, lazy: bool = False,
               seq: torch.Tensor | None = None, true_delay=None,
               quota: torch.Tensor | None = None) -> tuple[dict, dict]:
    """Enqueue prefetch candidates ``[S, K]`` into the in-flight rings.

    ``delay`` (and ``true_delay``) is an int, ``int32[S]`` or
    ``int32[S, K]``, clamped to >= 1. Entries get ``deadline = now +
    delay`` and ``ready = now + true_delay`` (``true_delay=None``: the
    clean fabric, ``ready == deadline``). A candidate is enqueued only if
    in range, not resident and not already in flight; a full ring, or a
    stream past its ``quota int32[S]`` of takes (the chaos grants axis),
    drops it and counts ``n_drops``.
    """
    del lazy
    R = ring["page"].shape[1]
    if R == 0:
        return st, ring
    S, K = pages.shape
    n_pages = st["page_slot"].shape[1]
    dev = pages.device

    def per_cand(d):
        d = torch.as_tensor(d, dtype=I32, device=dev).clamp(min=1)
        if d.dim() == 1:
            d = d[:, None]
        return d.expand(S, K)

    delay = per_cand(delay)
    true_delay = delay if true_delay is None else per_cand(true_delay)
    if seq is None:
        seq = torch.zeros((S, K), dtype=I32, device=dev)
    q = (torch.full((S,), 1 << 30, dtype=I32, device=dev) if quota is None
         else torch.as_tensor(quota, dtype=I32, device=dev).expand(S))
    pages = pages.to(I32)
    for k in range(K):
        page = pages[:, k]
        in_range = (page >= 0) & (page < n_pages)
        p_safe = page.clamp(0, n_pages - 1)
        resident = _get(st["page_slot"], p_safe) >= 0
        in_flight = ((ring["page"] == page[:, None])
                     & (ring["page"] >= 0)).any(1)
        want = valid[:, k] & in_range & ~resident & ~in_flight
        free_mask = ring["page"] < 0
        have_space = free_mask.any(1) & (q > 0)
        pos = torch.argmax(free_mask.to(I32), dim=1)
        take = want & have_space
        ring = dict(ring)
        ring["page"] = _set(ring["page"], pos, p_safe, take)
        ring["ready"] = _set(ring["ready"], pos, now + true_delay[:, k], take)
        ring["deadline"] = _set(ring["deadline"], pos, now + delay[:, k], take)
        ring["issued_at"] = _set(ring["issued_at"], pos, now, take)
        ring["seq"] = _set(ring["seq"], pos, seq[:, k], take)
        st = dict(st)
        st["n_prefetch_issued"] = st["n_prefetch_issued"] + _i(take)
        ring["n_drops"] = ring["n_drops"] + _i(want & ~have_space)
        q = q - _i(take)
    return st, ring


def _land_due(st: dict, ring: dict, hot, pool, now: torch.Tensor,
              lazy: bool, land_ok: torch.Tensor | None):
    """Phase 1 of the wait path: land every due (and granted) ring entry.

    Returns ``(st, ring, hot, landed_pages, landed_slots, landed_issued)``,
    the last three ``int32[S, R]`` with ``-1`` where nothing landed.
    """
    S, R = ring["page"].shape
    dev = ring["page"].device
    neg = torch.full((S,), -1, dtype=I32, device=dev)
    lp, ls, li = [], [], []
    if land_ok is None:
        land_ok = torch.ones((S, R), dtype=torch.bool, device=dev)
    for i in range(R):
        p = ring["page"][:, i]
        due = (p >= 0) & (ring["ready"][:, i] <= now) & land_ok[:, i]
        p_safe = p.clamp(min=0)
        resident = _get(st["page_slot"], p_safe) >= 0
        commit = due & ~resident
        st_c, slot = _alloc_slot(st, lazy)
        st_c["clock"] = st_c["clock"] + 1
        st_c = _map_slot(st_c, slot, p_safe, torch.ones_like(commit))
        st = _where(commit, st_c, st)
        hot = _payload_where(
            commit, _payload_store(hot, slot, _payload_page(pool, p_safe)),
            hot)
        lp.append(torch.where(commit, p_safe, neg))
        ls.append(torch.where(commit, slot, neg))
        li.append(torch.where(commit, ring["issued_at"][:, i], neg))
        st["n_pollution"] = st["n_pollution"] + _i(due & resident)
        st["n_deferred"] = st["n_deferred"] + _i(
            due & (ring["deadline"][:, i] < now))
        ring = dict(ring)
        ring["page"] = ring["page"].clone()
        ring["page"][:, i] = torch.where(due, neg, p)
    if R == 0:
        empty = torch.zeros((S, 0), dtype=I32, device=dev)
        return st, ring, hot, empty, empty, empty
    stack = lambda xs: torch.stack(xs, dim=1)
    return st, ring, hot, stack(lp), stack(ls), stack(li)


def _serve_demand(st: dict, ring: dict, hot, pool, page: torch.Tensor,
                  now: torch.Tensor, lazy: bool):
    """Phase 2 of the wait path: serve one demand access per stream.
    Returns ``(st, ring, hot, out_slot, info)``."""
    R = ring["page"].shape[1]
    n_pages = st["page_slot"].shape[1]
    in_range = (page >= 0) & (page < n_pages)
    p_safe = page.clamp(0, n_pages - 1)
    st = dict(st)
    st["clock"] = st["clock"] + _i(in_range)
    slot0 = _get(st["page_slot"], p_safe)
    resident = in_range & (slot0 >= 0)
    s_safe = slot0.clamp(min=0)
    was_pref_hit = (resident & _get(st["slot_prefetched"], s_safe)
                    & ~_get(st["slot_consumed"], s_safe))
    if R > 0:
        match = (ring["page"] == page[:, None]) & (ring["page"] >= 0)
        partial = in_range & ~resident & match.any(1)
        match_i = torch.argmax(match.to(I32), dim=1)
        ring = dict(ring)
        ring["page"] = _set(ring["page"], match_i, NO_PAGE, partial)
        st["n_deferred"] = st["n_deferred"] + _i(
            partial & (_get(ring["deadline"], match_i) < now))
    else:
        partial = torch.zeros_like(in_range)
    miss = in_range & ~resident & ~partial
    st["n_hits"] = st["n_hits"] + _i(resident | partial)
    st["n_prefetch_hits"] = st["n_prefetch_hits"] + _i(was_pref_hit | partial)
    st["n_partial_hits"] = st["n_partial_hits"] + _i(partial)
    st["n_misses"] = st["n_misses"] + _i(miss)
    st["slot_consumed"] = _set(st["slot_consumed"], s_safe, True, resident)
    st["slot_last_use"] = _set(st["slot_last_use"], s_safe, st["clock"],
                               resident)
    if not lazy:
        st = _where(was_pref_hit, _unmap(st, s_safe), st)

    need_fetch = partial | miss
    st_f, slot_new = _alloc_slot(st, lazy)
    st_f = _map_slot(st_f, slot_new, p_safe, torch.zeros_like(need_fetch))
    st = _where(need_fetch, st_f, st)
    hot = _payload_where(
        need_fetch, _payload_store(hot, slot_new, _payload_page(pool, p_safe)),
        hot)
    give_back = need_fetch & (not lazy)
    if not lazy:
        st = _where(give_back, _unmap(st, slot_new), st)
    none = torch.full_like(slot0, NO_SLOT)
    freed = torch.where(was_pref_hit & (not lazy), s_safe,
                        torch.where(give_back, slot_new, none))
    st = _free_push(st, freed.clamp(min=0), freed >= 0)
    out_slot = torch.where(resident, slot0,
                           torch.where(need_fetch, slot_new, none))
    info = {"hit": resident, "prefetched_hit": was_pref_hit,
            "partial_hit": partial, "fetched": need_fetch}
    return st, ring, hot, out_slot, info


def pool_wait(st: dict, ring: dict, hot, pool, page: torch.Tensor,
              now: torch.Tensor, lazy: bool = False,
              land_ok: torch.Tensor | None = None):
    """Wait phase with one demand page a stream (``page int32[S]``): land
    every due (and granted, ``land_ok bool[S, R]``) ring entry, then serve
    the demand (resident hit, partial hit on an in-flight entry, or miss).

    Returns ``(st, ring, hot, slot [S], data, info)``: ``data`` is the
    serving slot's payload (leaves ``[S, ...]``; ``None`` metadata-only);
    ``info`` has the ``[S]`` masks ``hit`` / ``prefetched_hit`` /
    ``partial_hit`` / ``fetched`` and the landing copy plan ``landed`` /
    ``landed_pages`` / ``landed_slots`` / ``landed_issued`` ``[S, R]``.
    """
    page = page.to(I32)
    st, ring, hot, lp, ls, li = _land_due(st, ring, hot, pool, now, lazy,
                                          land_ok)
    st, ring, hot, out_slot, info = _serve_demand(st, ring, hot, pool, page,
                                                  now, lazy)
    info = dict(info, landed=lp >= 0, landed_pages=lp, landed_slots=ls,
                landed_issued=li)
    return st, ring, hot, out_slot, _payload_slots(hot, out_slot), info


def pool_wait_batch(st: dict, ring: dict, hot, pool, pages: torch.Tensor,
                    valid: torch.Tensor, now: torch.Tensor,
                    lazy: bool = False, land_ok: torch.Tensor | None = None):
    """Wait phase with a multi-page demand batch ``[S, D]``: land due ring
    arrivals once, then serve the D demands in order.

    Returns ``(st, ring, hot, slots [S, D], info)``; ``info`` has the
    per-demand masks and the landing copy plan ``landed`` /
    ``landed_pages`` / ``landed_slots`` / ``landed_issued`` ``[S, R]``.
    """
    _check_batch_geometry(st, pages.shape[1], lazy, "pool_wait_batch")
    st, ring, hot, lp, ls, li = _land_due(st, ring, hot, pool, now, lazy,
                                          land_ok)
    cols = {"slot": [], "hit": [], "prefetched_hit": [], "partial_hit": [],
            "fetched": []}
    pages = pages.to(I32)
    for d in range(pages.shape[1]):
        page = torch.where(valid[:, d], pages[:, d],
                           torch.full_like(pages[:, d], NO_PAGE))
        st, ring, hot, slot, info = _serve_demand(st, ring, hot, pool, page,
                                                  now, lazy)
        cols["slot"].append(slot)
        for k in ("hit", "prefetched_hit", "partial_hit", "fetched"):
            cols[k].append(info[k])
    stack = lambda xs: torch.stack(xs, dim=1)
    info = {k: stack(cols[k]) for k in ("hit", "prefetched_hit",
                                        "partial_hit", "fetched")}
    info.update(landed=lp >= 0, landed_pages=lp, landed_slots=ls,
                landed_issued=li)
    return st, ring, hot, stack(cols["slot"]), info


def pool_invalidate(st: dict, ring: dict, pages: torch.Tensor,
                    valid: torch.Tensor) -> tuple[dict, dict]:
    """Drop pages ``[S, P]`` from the hot tiers and the in-flight rings
    (write coherence); an unconsumed prefetch or an in-flight entry counts
    ``n_pollution``."""
    R = ring["page"].shape[1]
    n_pages = st["page_slot"].shape[1]
    pages = pages.to(I32)
    for k in range(pages.shape[1]):
        page = pages[:, k]
        ok = valid[:, k] & (page >= 0) & (page < n_pages)
        p_safe = page.clamp(0, n_pages - 1)
        slot = _get(st["page_slot"], p_safe)
        resident = ok & (slot >= 0)
        s_safe = slot.clamp(min=0)
        was_unconsumed = (resident & _get(st["slot_prefetched"], s_safe)
                          & ~_get(st["slot_consumed"], s_safe))
        st_u = _free_push(_unmap(st, s_safe), s_safe)
        st = _where(resident, st_u, st)
        st["n_pollution"] = st["n_pollution"] + _i(was_unconsumed)
        if R > 0:
            match = ((ring["page"] == page[:, None]) & (ring["page"] >= 0)
                     & ok[:, None])
            inflight = match.any(1)
            mi = torch.argmax(match.to(I32), dim=1)
            ring = dict(ring)
            ring["page"] = _set(ring["page"], mi, NO_PAGE, inflight)
            st["n_pollution"] = st["n_pollution"] + _i(inflight)
    return st, ring


def link_grants(ring: dict, now: torch.Tensor, cap) -> torch.Tensor:
    """Budgeted landing grants across the stacked rings of one shared link:
    due entries (``ready <= now``) in ascending global ``seq`` up to
    ``cap`` landings this step. Returns ``bool[S, R]``."""
    due = (ring["page"] >= 0) & (ring["ready"] <= now[:, None])
    flat_due = due.reshape(-1)
    flat_seq = ring["seq"].reshape(-1)
    rank = (flat_due[None, :]
            & (flat_seq[None, :] < flat_seq[:, None])).sum(1)
    return (flat_due & (rank < cap)).reshape(due.shape)


def link_grants_sharded(ring: dict, now: torch.Tensor, caps: torch.Tensor,
                        homes: torch.Tensor,
                        mig_src: torch.Tensor | None = None,
                        mig_valid: torch.Tensor | None = None,
                        mig_seq: torch.Tensor | None = None):
    """Per-shard landing grants: due entries in ascending global ``seq`` up
    to each home shard's cap. Returns ``bool[S, R]``.

    With ``mig_src`` / ``mig_valid`` / ``mig_seq`` (migration proposals:
    the page's current home, validity, global proposal order) the third
    class rides on top and the result is ``(grants, mig_ok)``: proposals
    take, in ascending ``mig_seq``, what each source NIC has left after
    its prefetch grants, so demand > prefetch > migration."""
    due = (ring["page"] >= 0) & (ring["ready"] <= now[:, None])
    flat_due = due.reshape(-1)
    flat_seq = ring["seq"].reshape(-1)
    flat_home = homes.reshape(-1)
    same_shard = flat_home[None, :] == flat_home[:, None]
    rank = (flat_due[None, :] & same_shard
            & (flat_seq[None, :] < flat_seq[:, None])).sum(1)
    cap_of = caps[flat_home.clamp(0, caps.shape[0] - 1).long()]
    grants = (flat_due & (rank < cap_of)).reshape(due.shape)
    if mig_valid is None:
        return grants
    n_shards = caps.shape[0]
    pf_on = torch.zeros((n_shards,), dtype=caps.dtype,
                        device=caps.device).index_add_(
        0, flat_home.clamp(0, n_shards - 1).long(),
        grants.reshape(-1).to(caps.dtype))
    leftover = (caps - pf_on).clamp(min=0)
    mv = mig_valid.reshape(-1)
    ms = mig_seq.reshape(-1)
    mh = mig_src.reshape(-1).clamp(0, n_shards - 1).long()
    mig_rank = (mv[None, :] & (mh[None, :] == mh[:, None])
                & (ms[None, :] < ms[:, None])).sum(1)
    mig_ok = (mv & (mig_rank < leftover[mh])).reshape(mig_valid.shape)
    return grants, mig_ok


def pool_stats(st: dict, ring: dict | None = None) -> dict:
    """Host-side counter summary of ONE stream's state (leaves without the
    stream dim), with the issued-prefetch decomposition when ``ring`` is
    given."""
    g = lambda k: int(st[k])
    issued, phits = g("n_prefetch_issued"), g("n_prefetch_hits")
    partial = g("n_partial_hits")
    faults = g("n_hits") + g("n_misses")
    resident_unused = int(((st["slot_page"] >= 0) & st["slot_prefetched"]
                           & ~st["slot_consumed"]).sum())
    out = {
        "faults": faults,
        "hits": g("n_hits"),
        "misses": g("n_misses"),
        "prefetch_issued": issued,
        "prefetch_hits": phits,
        "partial_hits": partial,
        "deferred": g("n_deferred"),
        "pollution": g("n_pollution"),
        "resident_unused": resident_unused,
        "alloc_scans": g("n_alloc_scans"),
        "accuracy": phits / issued if issued else 0.0,
        "coverage": phits / faults if faults else 0.0,
        "latency_hidden_frac": (phits - partial) / phits if phits else 1.0,
    }
    if ring is not None:
        out["inflight_at_end"] = int((ring["page"] >= 0).sum())
        out["ring_drops"] = int(ring["n_drops"])
    return out
