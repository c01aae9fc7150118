"""Tiered paged-KV: a Leap-managed hot pool per stream feeding decode attention.

Counterpart of ``src/repro/paging/tiered_kv.py``: on the single-link path
(``fabric=None``) and on a sharded cold pool (``fabric`` of any shard
count: per-NIC budgets, near/far deadlines), on its flat data plane or,
with a ``mesh``, on its mesh plane (each rank of the fabric group holds
its home slice and the gathers run in a ring,
:func:`repro_torch.paging.sharded_pool.fabric_ring_gather`); with or
without the §12 lifecycle's tables (``home_map`` / ``comp_map``, which
steer the scheduling only: the bytes move from the static placement). The
state is a dict of ``{"leap",
"pool_meta", "ring", "hot"}`` whose leaves carry a leading stream
dimension, where the reference vmaps. The chunked sweep is a Python loop
over chunk steps; each step runs the metadata transactions for all streams
at once, then moves the bytes through the gather kernel
(``gather_pages`` on the sync path, ``gather_pages_async`` on the async
path): one call per K/V leaf on the flat plane, one a leaf a ring round on
the mesh plane. Attention then reads the hot tier: unfused
through the stacked pool and the flat kernel (``"kernel"``) or its plain
version (``"ref"``), or in place through the hot-slot kernel (``"fused"``)
or its ``cp.async`` double-buffered twin (``"fused_async"``).

Functions return new state dicts. Two write into the state they are given:
:func:`tiered_sweep` writes the copied pages into the hot tier's K/V
leaves in place (the metadata leaves it returns are new tensors), and
:func:`tiered_reset_stream` resets one stream in place.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.leap import DEFAULT_PW_MAX, leap_init, leap_step
from repro_torch.core.pool import (NO_PAGE, link_grants_sharded, page_home,
                                   pool_access, pool_init, pool_invalidate,
                                   pool_issue, pool_wait_batch, ring_init)
from repro_torch.device import cached_arange, resolve_device
from repro_torch.kernels.gather_pages import gather_pages, gather_pages_async
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_hot_slots)
from repro_torch.paging.prefetch_serving import stream_stats_at
from repro_torch.paging.sharded_pool import (ShardedPoolCfg,
                                             check_fabric_topology,
                                             mesh_plane, scatter_hot,
                                             stream_homes)

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class TieredKV:
    """Static geometry of the tiered paged-KV cache (see the reference)."""
    n_pages: int
    n_slots: int
    page_size: int
    n_kv_heads: int
    head_dim: int
    chunk: int = 4
    pw_max: int = DEFAULT_PW_MAX
    h_size: int = 32
    n_split: int = 8
    ring_size: int = 8
    arrival_delay: int = 1
    use_kernel: bool = True

    @property
    def page_shape(self) -> tuple[int, int, int]:
        return (self.page_size, self.n_kv_heads, self.head_dim)


def tiered_min_slots(npps: int, geom: TieredKV) -> int:
    """Hot-slot floor for a sweep of ``npps`` pages per decode step."""
    return min(npps + geom.chunk + max(geom.pw_max, geom.ring_size) + 2,
               geom.n_pages)


def tiered_init(geom: TieredKV, n_streams: int, dtype=torch.bfloat16,
                device=None) -> dict:
    """Stacked per-stream tiered state (leading ``[n_streams]`` dim)."""
    dev = resolve_device(device)
    S = n_streams
    kv = lambda: torch.zeros((S, geom.n_slots) + geom.page_shape,
                             dtype=dtype, device=dev)
    return {
        "leap": leap_init(geom.h_size, (S,), dev),
        "pool_meta": pool_init(geom.n_pages, geom.n_slots, S, dev),
        "ring": ring_init(geom.ring_size, S, dev),
        "hot": {"k": kv(), "v": kv()},
    }


def _apply_copies(hot: dict, cold: dict, src: torch.Tensor,
                  dst: torch.Tensor, mask: torch.Tensor, *, gather) -> dict:
    """Data plane: ``cold[src] -> hot[dst]`` where ``mask``, k and v
    together, for all streams; writes ``hot`` in place. ``gather(cold,
    pages)`` moves the bytes (:func:`_data_plane`)."""
    S = src.shape[0]
    data = gather(cold, src.clamp(min=0).reshape(-1).to(I32))
    data = {k: d.reshape((S, -1) + tuple(d.shape[1:]))
            for k, d in data.items()}
    return scatter_hot(hot, data, dst, mask)


def _data_plane(cold: dict, geom: TieredKV, async_datapath: bool,
                fabric: ShardedPoolCfg, mesh) -> tuple:
    """``(cold, gather)`` of the sweep's data plane, the gather kernel
    (``gather_pages_async`` on the async path, else ``gather_pages``)
    picking the pages. Flat: the whole pool, one call per leaf. Mesh
    (``mesh`` with ``n_shards > 1``): this rank's ``[pps, ...]`` home
    slice and the :func:`repro_torch.paging.sharded_pool.fabric_ring_gather`
    ring, the kernel picking each visiting slice's pages at their
    ``page_local`` indices."""
    gfn = gather_pages_async if async_datapath else gather_pages
    pick = functools.partial(gfn, use_kernel=geom.use_kernel)
    if mesh is not None and fabric.n_shards > 1:
        return mesh_plane(cold, geom.n_pages, fabric, mesh, pick)
    return cold, lambda c, pages: {k: pick(v, pages) for k, v in c.items()}


def _leap_chunk(leap: dict, pages: torch.Tensor, feedback: torch.Tensor,
                valid: torch.Tensor, geom: TieredKV):
    """Feed one chunk ``[S, C]`` of demand accesses through the controller;
    the emitted candidates are the frontier's (the last valid page)."""
    S, C = pages.shape
    cands_all, cvalid_all = [], []
    for c in range(C):
        v = valid[:, c]
        lp2, cands, cvalid = leap_step(leap, pages[:, c].clamp(min=0),
                                       feedback[:, c], n_split=geom.n_split,
                                       pw_max=geom.pw_max)
        leap = {k: torch.where(v.reshape((S,) + (1,) * (a.dim() - 1)),
                               lp2[k], a) for k, a in leap.items()}
        cands_all.append(cands)
        cvalid_all.append(cvalid & v[:, None])
    cands_all = torch.stack(cands_all, 1)                 # [S, C, pw]
    cvalid_all = torch.stack(cvalid_all, 1)
    ar = cached_arange(C, pages.device)
    last = torch.argmax(torch.where(valid, ar, -1), dim=1).clamp(min=0)
    rows = cached_arange(S, pages.device)
    return (leap, cands_all[rows, last],
            cvalid_all[rows, last] & valid.any(1)[:, None])


def _chunk_sync(leap: dict, meta: dict, pages: torch.Tensor, geom: TieredKV):
    """One sync chunk step for all streams: controller first, then one
    blocking batched transaction carrying the demands and the candidates."""
    S, C = pages.shape
    valid_d = pages >= 0
    p_safe = pages.clamp(0, geom.n_pages - 1).long()
    slot0 = torch.gather(meta["page_slot"], 1, p_safe)
    s_safe = slot0.clamp(min=0).long()
    was_pref = (valid_d & (slot0 >= 0)
                & torch.gather(meta["slot_prefetched"], 1, s_safe)
                & ~torch.gather(meta["slot_consumed"], 1, s_safe))
    leap, cands, cvalid = _leap_chunk(leap, pages, was_pref, valid_d, geom)
    req = torch.cat([pages, cands], 1)
    dev = pages.device
    is_pf = torch.cat([torch.zeros((S, C), dtype=torch.bool, device=dev),
                       torch.ones((S, geom.pw_max), dtype=torch.bool,
                                  device=dev)], 1)
    val = torch.cat([valid_d,
                     cvalid & (cands >= 0) & (cands < geom.n_pages)], 1)
    meta, _, slots, info = pool_access(meta, None, None, req, is_pf, val,
                                       lazy=True)
    issued = info["fetched"][:, C:].sum(1, dtype=I32)
    return leap, meta, slots, info, req, issued


def _chunk_async(leap: dict, meta: dict, ring: dict, pages: torch.Tensor,
                 land_ok: torch.Tensor, seq: torch.Tensor,
                 home_s: torch.Tensor, geom: TieredKV,
                 fabric: ShardedPoolCfg, home_tab=None, comp_tab=None,
                 mig_delay: int = 0):
    """One async chunk step for all streams: wait (land + serve the
    chunk's demands), controller, issue. ``home_tab`` (``int32[n_pages]``)
    replaces the placement formula in the near/far deadlines; ``comp_tab``
    (``bool[n_pages]``) adds ``mig_delay`` steps to a compressed
    candidate's."""
    now = ring["now"]
    valid_d = pages >= 0
    deferred0 = meta["n_deferred"]
    issued0 = meta["n_prefetch_issued"]
    meta, ring, _, slots, winfo = pool_wait_batch(
        meta, ring, None, None, pages, valid_d, now, lazy=True,
        land_ok=land_ok)
    fb = winfo["prefetched_hit"] | winfo["partial_hit"]
    leap, cands, cvalid = _leap_chunk(leap, pages, fb, valid_d, geom)
    cval = cvalid & (cands >= 0) & (cands < geom.n_pages)
    c_safe = cands.clamp(0, geom.n_pages - 1).long()
    homes_c = (page_home(cands, geom.n_pages, fabric.n_shards,
                         fabric.placement) if home_tab is None
               else home_tab[c_safe])
    delay = torch.where(homes_c == home_s[:, None],
                        torch.full_like(homes_c, fabric.near_delay),
                        torch.full_like(homes_c, fabric.far_delay))
    if comp_tab is not None:
        delay = delay + comp_tab[c_safe].to(I32) * mig_delay
    meta, ring = pool_issue(meta, ring, cands, cval, now, delay, seq=seq)
    ring = dict(ring)
    ring["now"] = now + 1
    issued = meta["n_prefetch_issued"] - issued0
    deferred = meta["n_deferred"] - deferred0
    return leap, meta, ring, slots, winfo, issued, deferred


def _sweep_fn(state: dict, cold: dict, sched: torch.Tensor, geom: TieredKV,
              async_datapath: bool, fabric: ShardedPoolCfg,
              gather, lifecycle: dict | None = None, mig_delay: int = 0):
    """Lock-step sweep over ``sched [n_chunks, S, chunk]``. ``lifecycle``
    (``{"home", "comp"}`` tables) steers the per-NIC caps, the deadlines
    and the demand accounting; the bytes still move from the static
    placement. ``gather`` is the data plane (:func:`_data_plane`)."""
    n_chunks, S, C = sched.shape
    G = fabric.n_shards
    dev = sched.device
    stream_ids = torch.arange(S, dtype=I32, device=dev)
    homes_s = stream_homes(S, G, dev)
    shard_ids = torch.arange(G, dtype=I32, device=dev)
    home_tab = None if lifecycle is None else lifecycle["home"]
    comp_tab = None if lifecycle is None else lifecycle.get("comp")
    homes = ((lambda p: page_home(p, geom.n_pages, G, fabric.placement))
             if home_tab is None else
             (lambda p: home_tab[p.clamp(0, geom.n_pages - 1).long()]))
    d_prev = torch.zeros((G,), dtype=I32, device=dev)
    cols = {k: [] for k in ("hit", "pref_hit", "partial_hit", "fetched",
                            "issued", "landed", "deferred",
                            "link_demand_fetches", "shard_demand_fetches")}
    cnt = lambda m: m.sum(1, dtype=I32)
    for c in range(n_chunks):
        pages = sched[c]
        leap, meta = state["leap"], state["pool_meta"]
        ring, hot = state["ring"], state["hot"]
        if async_datapath:
            now = ring["now"]
            if fabric.link_budget is not None:
                caps = (fabric.link_budget - d_prev).clamp(min=0)
                ok = link_grants_sharded(ring, now, caps, homes(ring["page"]))
            else:
                ok = torch.ones(ring["page"].shape, dtype=torch.bool,
                                device=dev)
            ar = cached_arange(geom.pw_max, dev)
            seq = (now * S + stream_ids)[:, None] * geom.pw_max + ar[None, :]
            leap, meta, ring, slots, info, issued, deferred = _chunk_async(
                leap, meta, ring, pages, ok, seq, homes_s, geom, fabric,
                home_tab, comp_tab, mig_delay)
            # copy plan: landings first, then demand fetches
            src = torch.cat([info["landed_pages"],
                             torch.where(info["fetched"], pages,
                                         torch.full_like(pages, NO_PAGE))], 1)
            dst = torch.cat([info["landed_slots"], slots], 1)
            mask = torch.cat([info["landed"], info["fetched"]], 1)
            landed = cnt(info["landed"])
        else:
            leap, meta, slots, info, req, issued = _chunk_sync(
                leap, meta, pages, geom)
            src, dst, mask = req, slots, info["fetched"]
            info = {"hit": info["hit"][:, :C],
                    "prefetched_hit": info["prefetched_hit"][:, :C],
                    "partial_hit": torch.zeros((S, C), dtype=torch.bool,
                                               device=dev),
                    "fetched": info["fetched"][:, :C]}
            deferred = torch.zeros((S,), dtype=I32, device=dev)
            landed = issued
        hot = _apply_copies(hot, cold, src, dst, mask, gather=gather)
        state = {"leap": leap, "pool_meta": meta, "ring": ring, "hot": hot}
        d_t = cnt(info["fetched"])
        homes_d = homes(pages)
        d_t_shard = ((homes_d[..., None] == shard_ids)
                     & info["fetched"][..., None]).sum((0, 1), dtype=I32)
        d_prev = d_t_shard
        for k, v in (("hit", cnt(info["hit"])),
                     ("pref_hit", cnt(info["prefetched_hit"])),
                     ("partial_hit", cnt(info["partial_hit"])),
                     ("fetched", d_t), ("issued", issued.to(I32)),
                     ("landed", landed.to(I32)),
                     ("deferred", deferred.to(I32)),
                     ("link_demand_fetches", d_t.sum(dtype=I32)),
                     ("shard_demand_fetches", d_t_shard)):
            cols[k].append(v)
    info = {k: torch.stack(cols[k], 1) for k in
            ("hit", "pref_hit", "partial_hit", "fetched", "issued", "landed",
             "deferred")}                                     # [S, n_chunks]
    info["link_demand_fetches"] = torch.stack(cols["link_demand_fetches"])
    info["shard_demand_fetches"] = torch.stack(cols["shard_demand_fetches"])
    return state, info


def tiered_sweep(state: dict, cold: dict, page_rows: torch.Tensor,
                 geom: TieredKV, *, async_datapath: bool = False,
                 link_budget: int | None = None,
                 fabric: ShardedPoolCfg | None = None, mesh=None,
                 home_map=None, comp_map=None,
                 decompress_delay: int = 0) -> tuple[dict, dict]:
    """Sweep every stream's context pages ``page_rows int32[S, npps]``
    through its hot pool, chunked; returns ``(state, info)`` with per-stream
    ``int32[S, n_chunks]`` counts and the link / per-NIC demand columns,
    as the reference. ``-1`` entries are skipped.

    ``fabric`` (:class:`ShardedPoolCfg`) shards the cold pool: the budget
    becomes per NIC and prefetch deadlines near / far by home shard
    (stream s lives on shard ``s % n_shards``); ``link_budget`` is then
    ignored. ``cold`` stays in page-id order. Without ``mesh`` the bytes
    move by the same gather launches as on one shard; with ``mesh`` (a
    DeviceMesh with a ``"fabric"`` dim of ``n_shards`` ranks, every rank
    calling with the same arguments) each rank reads only its home slice
    of ``cold``, placed anew each call, and the pages move in a ring
    through the gather kernels; every rank's state and ``info`` are then
    bitwise the flat plane's.

    ``home_map`` (``int32[n_pages]``, the §12 lifecycle's time-varying
    homes, e.g. :meth:`PageLifecycle.home_map`) replaces the placement
    formula in the per-NIC caps, the near/far deadlines and the per-NIC
    demand accounting; ``comp_map`` (``bool[n_pages]``) adds
    ``decompress_delay`` chunk steps to the deadline of a prefetch of a
    compressed page. Both ``None`` is the exact two-tier sweep."""
    S, npps = page_rows.shape
    if geom.n_slots < tiered_min_slots(npps, geom):
        raise ValueError(
            f"n_slots={geom.n_slots} below tiered_min_slots("
            f"{npps} pages) = {tiered_min_slots(npps, geom)}: the swept row "
            "would not stay resident for attention")
    if async_datapath and geom.ring_size == 0:
        async_datapath = False
    if fabric is None:
        delay = max(geom.arrival_delay, 1)
        fabric = ShardedPoolCfg(
            n_shards=1, placement="interleave",
            link_budget=None if link_budget is None else int(link_budget),
            near_delay=delay, far_delay=delay)
    check_fabric_topology(geom.n_pages, fabric, mesh)
    C = geom.chunk
    n_chunks = -(-npps // C)
    pad = n_chunks * C - npps
    rows = page_rows.to(I32)
    sched = torch.cat([rows, torch.full((S, pad), NO_PAGE, dtype=I32,
                                        device=rows.device)], 1)
    sched = sched.reshape(S, n_chunks, C).transpose(0, 1)
    lifecycle = None
    if home_map is not None or comp_map is not None:
        dev = rows.device
        lifecycle = {"home": (
            page_home(torch.arange(geom.n_pages, dtype=I32, device=dev),
                      geom.n_pages, fabric.n_shards, fabric.placement)
            if home_map is None else
            torch.as_tensor(home_map, device=dev).to(I32))}
        if comp_map is not None:
            lifecycle["comp"] = torch.as_tensor(comp_map,
                                                device=dev).to(torch.bool)
    cold, gather = _data_plane(cold, geom, async_datapath, fabric, mesh)
    return _sweep_fn(state, cold, sched, geom, async_datapath, fabric,
                     gather, lifecycle, int(decompress_delay))


def tiered_slot_table_local(state: dict, page_rows: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-stream hot-slot ids ``int32[S, npps]`` (``-1`` for invalid and
    non-resident entries) and whether every valid page is resident."""
    page_slot = state["pool_meta"]["page_slot"]
    n_pages = page_slot.shape[-1]
    safe = page_rows.clamp(0, n_pages - 1).long()
    slots = torch.gather(page_slot, 1, safe)
    valid = page_rows >= 0
    all_resident = ((slots >= 0) | ~valid).all()
    return torch.where(valid, slots, torch.full_like(slots, -1)).to(I32), \
        all_resident


def tiered_slot_table(state: dict, page_rows: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stacked-pool slot ids ``s * n_slots + slot`` (the unfused form)."""
    slots, all_resident = tiered_slot_table_local(state, page_rows)
    n_slots = state["hot"]["k"].shape[1]
    S = page_rows.shape[0]
    base = torch.arange(S, dtype=I32, device=slots.device)[:, None] * n_slots
    return (base + slots.clamp(min=0)).to(I32), all_resident


ATTN_KERNEL_MODES = ("ref", "kernel", "fused", "fused_async")


def normalize_attn_kernel(mode: str) -> str:
    """Normalize an ``attn_kernel`` selector to one of
    :data:`ATTN_KERNEL_MODES`, accepting the CLI spelling
    (``"fused-async"`` -> ``"fused_async"``); raise on anything else. (The
    reference also takes its legacy bools; no caller of the port passes
    one.)"""
    m = str(mode).replace("-", "_")
    if m not in ATTN_KERNEL_MODES:
        raise ValueError(f"attn_kernel={mode!r} not in {ATTN_KERNEL_MODES}")
    return m


def tiered_attention(q: torch.Tensor, state: dict, page_rows: torch.Tensor,
                     lengths: torch.Tensor, *, attn_kernel: str = "ref"):
    """Decode attention ``q [S,1,Hq,dh]`` served from the hot tier.

    ``"ref"`` / ``"kernel"``: the unfused path over the stacked
    ``[S * n_slots, ...]`` pool (plain version / flat kernel). ``"fused"`` /
    ``"fused_async"``: the hot-slot kernel (sync or ``cp.async``) reads the
    per-stream pools in place. On resident bytes all of them equal the
    flat-pool attention bitwise. Returns
    ``(out [S,1,Hq,dh], all_resident)``.
    """
    mode = normalize_attn_kernel(attn_kernel)
    hot = state["hot"]
    if mode in ("fused", "fused_async"):
        table, ok = tiered_slot_table_local(state, page_rows)
        return paged_attention_hot_slots(
            q, hot["k"], hot["v"], table, lengths,
            async_copy=(mode == "fused_async")), ok
    table, ok = tiered_slot_table(state, page_rows)
    S, n_slots = hot["k"].shape[:2]
    hk = hot["k"].reshape((S * n_slots,) + tuple(hot["k"].shape[2:]))
    hv = hot["v"].reshape((S * n_slots,) + tuple(hot["v"].shape[2:]))
    return paged_attention(q, hk, hv, table, lengths,
                           use_kernel=(mode == "kernel")), ok


def tiered_decode_step(state: dict, cold: dict, q: torch.Tensor,
                       page_rows: torch.Tensor, lengths: torch.Tensor,
                       geom: TieredKV, *, async_datapath: bool = False,
                       link_budget: int | None = None,
                       fabric: ShardedPoolCfg | None = None, mesh=None,
                       attn_kernel="ref", home_map=None, comp_map=None,
                       decompress_delay: int = 0):
    """Sweep, then attend over the hot tier; returns
    ``(state, out, info, all_resident)``."""
    state, info = tiered_sweep(state, cold, page_rows, geom,
                               async_datapath=async_datapath,
                               link_budget=link_budget, fabric=fabric,
                               mesh=mesh, home_map=home_map,
                               comp_map=comp_map,
                               decompress_delay=decompress_delay)
    out, ok = tiered_attention(q, state, page_rows, lengths,
                               attn_kernel=attn_kernel)
    return state, out, info, ok


def tiered_invalidate(state: dict, pages: torch.Tensor) -> dict:
    """Drop ``pages int32[S, P]`` from each stream's hot tier and ring;
    ``-1`` entries are ignored."""
    meta, ring = pool_invalidate(state["pool_meta"], state["ring"], pages,
                                 pages >= 0)
    return {**state, "pool_meta": meta, "ring": ring}


def tiered_reset_stream(state: dict, i: int, geom: TieredKV,
                        dtype=torch.bfloat16) -> dict:
    """Cold-reset stream ``i`` to a fresh init, IN PLACE (every leaf of
    ``state`` is written at row ``i``; the other streams are untouched).
    Returns ``state``."""
    dev = state["hot"]["k"].device
    fresh = tiered_init(geom, 1, dtype, dev)
    for group, leaves in fresh.items():
        for name, f in leaves.items():
            state[group][name][i] = f[0]
    return state


def tiered_stats(state: dict, i: int) -> dict:
    """Host-side pool counters of stream ``i``."""
    return stream_stats_at(state, i)
