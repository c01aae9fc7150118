"""Sharded cold pool: per-shard NICs, placement, near/far asymmetry.

Counterpart of ``repro.paging.sharded_pool``. The cold pool is split over
``n_shards`` home shards (one NIC each); a page's home comes from its
placement (``"block"`` or ``"interleave"``,
:func:`repro_torch.core.pool.page_home`). Scheduling follows the topology:

* **per-shard link budgets**: each NIC moves ``link_budget`` pages a step,
  demand first, its leftover landing prefetches homed on it in global
  issue order (:func:`repro_torch.core.pool.link_grants_sharded`);
* **near/far delays**: a prefetch of a page homed on the consuming
  stream's own shard (stream ``s`` lives on shard ``s % n_shards``)
  arrives after ``near_delay`` steps, a cross-shard one after
  ``far_delay``.

Two data planes move the same bytes:

* **flat** (``mesh=None``): the cold pool is one local tensor and pages
  are gathered by plain indexing; placement, budgets and delays shape
  what lands when;
* **mesh** (a ``torch.distributed`` DeviceMesh with a ``"fabric"`` dim of
  ``n_shards`` ranks, :func:`repro_torch.launch.mesh.make_fabric_mesh`):
  each rank holds only its home slice (:func:`home_slice`, the pages
  homed on it in :func:`place_cold`'s home-major order) and runs the same
  metadata scan, replicated; cross-shard pages reach it by
  :func:`fabric_ring_gather`, a ring of send / receive hops in which every
  rank keeps the entries homed on the visiting slice. The reference runs
  this plane under ``shard_map`` with ``lax.ppermute``.

``chaos`` (:class:`repro_torch.fabric.chaos.ChaosSpec`) injects the four
fault axes into the consume scan, and ``migration``
(:class:`repro_torch.paging.lifecycle.MigrationCfg`) runs the §12 page
lifecycle in it: hot-ward migration as the third grant class and, with
``compressed``, the compressed cold tier. Both steer scheduling only: the
data plane keeps gathering from the static placement, which is what keeps
the two planes bitwise equal.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.core.leap import leap_step_batched
from repro_torch.core.pool import (NO_PAGE, PLACEMENTS, _tree_map,
                                   link_grants_sharded, page_home,
                                   page_local, pool_invalidate, pool_issue,
                                   pool_wait,
                                   tier_demote, tier_heat_decay, tier_init,
                                   tier_migrate, tier_promote, tier_touch)
from repro_torch.device import cached_arange
from repro_torch.paging.lifecycle import (propose_migrations, resolve,
                                          revalidate_proposals,
                                          select_demotions)
from repro_torch.paging.prefetch_serving import _payload_checksum, stream_init

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ShardedPoolCfg:
    """Static fabric topology of the cold pool (see the reference)."""
    n_shards: int = 1
    placement: str = "interleave"
    link_budget: int | None = None
    near_delay: int = 1
    far_delay: int = 2

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {self.placement!r}")
        if self.n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if not 1 <= self.near_delay <= self.far_delay:
            raise ValueError("need 1 <= near_delay <= far_delay "
                             f"(got {self.near_delay}/{self.far_delay})")


def stream_homes(n_streams: int, n_shards: int, device=None) -> torch.Tensor:
    """Home shard of each stream: ``s % n_shards``."""
    return torch.remainder(torch.arange(n_streams, dtype=I32,
                                        device=device), n_shards)


def place_perm(n_pages: int, fabric: ShardedPoolCfg) -> np.ndarray:
    """Permutation putting pages in home-major order: ``placed[i] =
    cold[perm[i]]``, so shard g's slice ``[g*pps, (g+1)*pps)`` holds
    exactly the pages homed on g, each at its ``page_local`` index."""
    if n_pages % fabric.n_shards:
        raise ValueError(f"n_pages={n_pages} not divisible by "
                         f"n_shards={fabric.n_shards}")
    pages = np.arange(n_pages)
    pps = n_pages // fabric.n_shards
    if fabric.placement == "interleave":
        home, local = pages % fabric.n_shards, pages // fabric.n_shards
    else:
        home, local = pages // pps, pages % pps
    perm = np.empty(n_pages, np.int64)
    perm[home * pps + local] = pages
    return perm


def place_cold(cold, n_pages: int, fabric: ShardedPoolCfg):
    """Permute every payload leaf's page axis into home-major order."""
    return _tree_map(lambda c: c[torch.from_numpy(
        place_perm(n_pages, fabric)).to(c.device)], cold)


def home_slice(cold, n_pages: int, fabric: ShardedPoolCfg, rank: int):
    """Shard ``rank``'s home slice of every leaf: ``place_cold(cold)[rank *
    pps:(rank + 1) * pps]``, the pages homed on it at their ``page_local``
    indices (read from ``cold`` directly, without placing the rest)."""
    pps = n_pages // fabric.n_shards
    idx = place_perm(n_pages, fabric)[rank * pps:(rank + 1) * pps]
    return _tree_map(lambda c: c[torch.from_numpy(idx).to(c.device)], cold)


def check_fabric_topology(n_pages: int, fabric: ShardedPoolCfg,
                          mesh=None) -> None:
    """Entry-point validation, the reference's: the pool must split evenly
    over the shards, and a mesh (if given) must carry a ``"fabric"`` dim
    of ``n_shards`` ranks (read from ``mesh_dim_names`` and ``shape``)."""
    if n_pages % fabric.n_shards:
        raise ValueError(f"n_pages={n_pages} not divisible by "
                         f"n_shards={fabric.n_shards}")
    if mesh is None or fabric.n_shards == 1:
        return
    size = dict(zip(mesh.mesh_dim_names or (), mesh.shape)).get("fabric")
    if size != fabric.n_shards:
        raise ValueError(f"mesh fabric axis {size} != n_shards "
                         f"{fabric.n_shards}")


# --------------------------------------------------------------------------
# the flat data plane
# --------------------------------------------------------------------------
def _gather_flat(cold, pages: torch.Tensor):
    """Plain local gather of ``pages`` (any shape; clamped into range) from
    every leaf of the cold pool."""
    return _tree_map(
        lambda c: c[pages.clamp(0, c.shape[0] - 1).long()], cold)


# --------------------------------------------------------------------------
# the mesh data plane
# --------------------------------------------------------------------------
#: ring hops since the last :func:`reset_ring_stats`: count, bytes sent,
#: host seconds, and the route of the last hop
_RING = {"hops": 0, "bytes": 0, "seconds": 0.0, "route": None}


def reset_ring_stats() -> None:
    _RING.update(hops=0, bytes=0, seconds=0.0, route=None)


def ring_stats() -> dict:
    """This process's ring hops since the last :func:`reset_ring_stats`:
    ``hops``, ``bytes`` (sent), ``seconds`` (host time of the hops; on the
    staged route each starts after a device sync and ends with its bytes
    back on the device) and the last hop's ``route``."""
    return dict(_RING)


def ring_route(backend: str, device: torch.device) -> str:
    """How a hop moves a tensor on ``device`` over a group of ``backend``:
    ``"nccl"`` (CUDA tensors, directly), ``"gloo"`` (CPU tensors,
    directly) or ``"gloo_staged"`` (CUDA tensors through host memory:
    gloo's send / receive read the tensor's pointer on the host). Any
    other pairing raises."""
    if backend == "nccl" and device.type == "cuda":
        return "nccl"
    if backend == "gloo":
        return "gloo_staged" if device.type == "cuda" else "gloo"
    raise ValueError(f"fabric ring: no route for {device.type} tensors "
                     f"over a {backend!r} group")


def _ring_hop(buf: torch.Tensor, send_to: int, recv_from: int, group,
              route: str) -> torch.Tensor:
    """One rotation: send ``buf`` to ``send_to`` and receive its
    neighbour's from ``recv_from`` (global ranks), both posted before
    either is waited on."""
    import torch.distributed as dist
    staged = route == "gloo_staged"
    if staged:
        torch.cuda.synchronize(buf.device)
    t0 = time.perf_counter()
    out = buf.contiguous()
    if staged:
        out = out.cpu()
    got = torch.empty_like(out)
    for w in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, out, send_to, group),
             dist.P2POp(dist.irecv, got, recv_from, group)]):
        w.wait()
    if staged:
        got = got.to(buf.device)
    _RING["hops"] += 1
    _RING["bytes"] += out.numel() * out.element_size()
    _RING["seconds"] += time.perf_counter() - t0
    _RING["route"] = route
    return got


def fabric_ring_gather(buf: torch.Tensor, local: torch.Tensor,
                       homes: torch.Tensor, n_shards: int, pick,
                       group) -> torch.Tensor:
    """One-leaf collective gather over the fabric group (the reference's
    ``shard_map`` ring, on ``torch.distributed``).

    ``buf`` is this rank's home slice ``[pps, ...]``. At round ``r`` the
    slice of shard ``(me - r) % n_shards`` is visiting; every rank keeps
    the entries homed there (``homes``), read at their within-shard
    ``local`` indices by ``pick(buf, local)`` (plain indexing, or a
    gather kernel so that the bytes still move through it), then sends the
    visiting slice to ``(me + 1) % n_shards`` and receives the next from
    ``(me - 1) % n_shards``. After ``n_shards`` rounds every rank holds
    every requested entry, bit for bit the flat gather on the unplaced
    pool. The stream consume and the tiered sweep both ride it.
    """
    import torch.distributed as dist
    me = dist.get_rank(group)
    route = ring_route(dist.get_backend(group), buf.device)
    send_to = dist.get_global_rank(group, (me + 1) % n_shards)
    recv_from = dist.get_global_rank(group, (me - 1) % n_shards)
    out = None
    for r in range(n_shards):
        take = homes == (me - r) % n_shards
        picked = pick(buf, local)
        mask = take.reshape(tuple(take.shape)
                            + (1,) * (picked.dim() - take.dim()))
        out = torch.where(mask, picked,
                          picked.new_zeros(()) if out is None else out)
        if r < n_shards - 1:
            buf = _ring_hop(buf, send_to, recv_from, group, route)
    return out


def _pick_index(buf: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    return buf[local.long()]


def _gather_fabric(cold_local, pages: torch.Tensor, n_pages: int,
                   fabric: ShardedPoolCfg, group, pick=_pick_index):
    """Collective gather of ``pages`` from the sharded cold pool: the
    :func:`fabric_ring_gather` ring over each leaf, picking by ``pick``
    (plain indexing, or the tiered sweep's gather kernels)."""
    G = fabric.n_shards
    home = page_home(pages, n_pages, G, fabric.placement)
    local = page_local(pages, n_pages, G, fabric.placement).clamp(
        0, n_pages // G - 1)
    return _tree_map(
        lambda c: fabric_ring_gather(c, local, home, G, pick, group),
        cold_local)


def fabric_plane(mesh) -> tuple:
    """``(group, rank)`` of ``mesh``'s ``"fabric"`` dim: the process group
    the ring runs over and this rank's index in it (its home shard)."""
    return mesh.get_group("fabric"), mesh.get_local_rank("fabric")


def mesh_plane(cold, n_pages: int, fabric: ShardedPoolCfg, mesh,
               pick=_pick_index) -> tuple:
    """The mesh plane of this rank: ``(home slice of cold, gather)``, where
    ``gather(home_slice, pages)`` is the collective ring gather of
    ``pages`` (every rank of ``mesh``'s ``"fabric"`` group calls it with
    the same pages), picking each visiting slice's entries by ``pick``."""
    group, rank = fabric_plane(mesh)
    return (home_slice(cold, n_pages, fabric, rank),
            functools.partial(_gather_fabric, n_pages=n_pages, fabric=fabric,
                              group=group, pick=pick))


def scatter_hot(hot: dict, data: dict, dst: torch.Tensor,
                mask: torch.Tensor) -> dict:
    """Write gathered pages (leaves ``[S, K, ...page]``) into the stacked
    ``[S, n_slots, ...]`` hot pools at per-stream slots ``dst [S, K]`` where
    ``mask``, IN PLACE; returns ``hot``.

    Masked-out entries write nothing, even where they name a live entry's
    slot. The live slots of one stream must be distinct: a scatter with
    duplicate indices has no defined order on CUDA. The tiered sweep's copy
    plans never name one slot twice in a chunk step (a test pins this); a
    consume step's could only if more pages landed in it than the hot
    buffer has slots (``ring_size + 1 > n_slots``; the chaos sidecar gives
    every page a slot).
    """
    s_idx, k_idx = mask.nonzero(as_tuple=True)
    d_idx = dst[s_idx, k_idx].long()
    for name, h in (hot.items() if isinstance(hot, dict) else [(None, hot)]):
        d = data if name is None else data[name]
        h[s_idx, d_idx] = d[s_idx, k_idx].to(h.dtype)
    return hot


# --------------------------------------------------------------------------
# the consume scan
# --------------------------------------------------------------------------
def _per_shard(homes: torch.Tensor, mask: torch.Tensor, G: int
               ) -> torch.Tensor:
    """``int32[G]``: how many entries of ``mask`` sit on each (clamped)
    home shard."""
    return torch.zeros((G,), dtype=I32, device=homes.device).index_add_(
        0, homes.reshape(-1).clamp(0, G - 1).long(),
        mask.reshape(-1).to(I32))


def _consume(cold, schedules: torch.Tensor, geom, fabric: ShardedPoolCfg,
             chaos=None, migration=None, gather=_gather_flat):
    """Lock-step multi-stream consume over the sharded cold pool (the
    reference's ``_consume_impl``): ``gather(cold, pages)`` is the data
    plane, :func:`_gather_flat` over the whole pool or the ring over this
    rank's home slice. Per step:

    1. **grant**: shard g's landing capacity is ``link_budget`` less last
       step's demand fetches homed on g; due ring entries homed on g land
       in ascending global ``seq`` up to it;
    2. **wait/serve**: metadata-only :func:`pool_wait` with the grants;
    3. **issue**: the controllers' candidates, stamped with the global
       ``seq`` and the near/far deadline of their home;
    4. the copy plan (landings, then the demand fetch) moves the bytes.

    With ``chaos`` the step also kills the lost node's pages at its death
    step, takes the per-step budgets, dilates the physical delays, caps
    issues by the elastic grants, re-homes the dead shard's pages for
    scheduling, and updates the Q8 EWMA deadline estimate ``est_q [S, G]``
    from this step's landings (returned as ``info["est_q"]``).

    With ``migration`` (not ``None`` nor disabled) the step also runs the §12
    lifecycle, in the reference's order: heat decay (after a node death
    has invalidated and re-homed every page then homed on the dead shard,
    migrated-in pages included); re-validation of last step's proposals
    (those toward a dead shard are dropped and count as pollution); the
    grants with migration as the third class, then ``tier_migrate``, so
    that everything after reads the post-grant homes; promotion of every
    compressed page landed or demand-fetched, counted against the
    start-of-step snapshot; heat on the demands; the ``decompress_delay``
    surcharge on the issue of a compressed page (on ``true_delay`` too
    under chaos); demotion of the coldest pages; and next step's
    proposals.
    """
    schedules = schedules.to(I32)
    S, T = schedules.shape
    K = geom.pw_max
    G = fabric.n_shards
    n_pages = geom.n_pages
    budget = fabric.link_budget
    dev = schedules.device
    homes_s = stream_homes(S, G, dev)
    stream_ids = cached_arange(S, dev)
    shard_ids = cached_arange(G, dev)
    cand_ids = cached_arange(K, dev)

    mig = resolve(migration)
    cz = None
    if chaos is not None:
        from repro_torch.fabric.chaos import (EST_ONE, compile_chaos,
                                              est_init, est_step)
        cz = compile_chaos(chaos, n_steps=T, n_streams=S, n_shards=G,
                           n_pages=n_pages, placement=fabric.placement,
                           base_budget=budget)
        tab = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        dil_t, bud_t, grant_t = (tab(cz[k]) for k in ("dilation", "budget",
                                                      "grant"))
        home_tab = tab(cz["home"]).long()                   # [2, n_pages]
        t_fail = cz["t_fail"]
        dead = tab(cz["dead_pages"])
        est_q = tab(est_init(S, G, fabric.near_delay, fabric.far_delay))
    if mig is not None:
        tier = tier_init(n_pages, G, fabric.placement, device=dev)
        M = mig.mig_per_stream
        zs = lambda dt: torch.zeros((S, M), dtype=dt, device=dev)
        pend = (zs(I32), zs(I32), zs(torch.bool), zs(I32))
        if cz is not None and t_fail is not None:
            from repro_torch.fabric.chaos import rehome_shard
            dead_g = int(chaos.node_loss[0])
            rehome_vec = torch.tensor(
                [rehome_shard(p, dead_g, dead_g, G) for p in range(n_pages)],
                dtype=I32, device=dev)

    state = (stream_init(geom, cold.dtype, n_streams=S, device=cold.device)
             if torch.is_tensor(cold) else
             stream_init(geom, payload_like=cold, n_streams=S))
    d_prev = torch.zeros((G,), dtype=I32, device=dev)
    cols = {k: [] for k in ("sums", "hit", "pref_hit", "partial_hit",
                            "fetched", "issued", "landed", "deferred",
                            "shard_d", "link_i", "link_def", "migrated",
                            "promoted", "demoted", "mig_on", "pf_on")}
    for t in range(T):
        pages = schedules[:, t]
        meta, ring, hot = state["pool_meta"], state["ring"], state["hot"]
        now = ring["now"]
        if mig is not None:
            if cz is not None and t_fail is not None and t == t_fail:
                # node death re-homes the current table (migrated-in pages
                # included) and invalidates every page homed on the dead
                # shard, in page order as the reference's masked sweep
                kill = tier["home"] == dead_g
                dead_now = kill.nonzero()[:, 0].to(I32)
                dead_now = dead_now[None].expand(S, dead_now.shape[0])
                meta, ring = pool_invalidate(
                    meta, ring, dead_now,
                    torch.ones_like(dead_now, dtype=torch.bool))
                tier = dict(tier)
                tier["home"] = torch.where(kill, rehome_vec, tier["home"])
            tier = tier_heat_decay(tier)
            comp_pre = tier["comp"]                # start-of-step snapshot
            # reads the current binding of ``tier``: the grant phase below
            # rebinds it, so demand accounting and issue delays see this
            # step's migrations
            _home = lambda x: tier["home"][x.clamp(0, n_pages - 1).long()]
        elif cz is None:
            _home = lambda x: page_home(x, n_pages, G, fabric.placement)
        else:
            # scheduling home map, re-homed from the death step on; the
            # data plane keeps gathering from the physical placement
            hv = home_tab[1 if t_fail is not None and t >= t_fail else 0]
            _home = lambda x, hv=hv: hv[x.clamp(0, n_pages - 1).long()].to(
                I32)
            if t_fail is not None and t == t_fail:
                # node death at the top of the step: the dead shard's
                # resident prefetches and in-flight fetches are lost
                kill = dead[None].expand(S, dead.shape[0])
                meta, ring = pool_invalidate(meta, ring, kill,
                                             torch.ones_like(kill,
                                                             dtype=torch.bool))

        # --- per-shard landing grants (leftover NIC budget, global seq) ---
        if mig is not None:
            mp, md, mv0, msq = pend
            mv, msrc = revalidate_proposals(mp, md, mv0, msq, tier, t, mig)
            if cz is not None and t_fail is not None:
                # carried proposals toward the dead shard: dropped, and
                # counted as pollution of the proposing stream
                dead_hit = mv & (md == dead_g) & (t >= t_fail)
                meta = dict(meta)
                meta["n_pollution"] = (meta["n_pollution"]
                                       + dead_hit.sum(1, dtype=I32))
                mv = mv & ~dead_hit
            if cz is not None:
                caps = (bud_t[t] - d_prev).clamp(min=0)
            elif budget is not None:
                caps = (budget - d_prev).clamp(min=0)
            else:
                caps = None
            if caps is None:
                allowed = torch.ones(ring["page"].shape, dtype=torch.bool,
                                     device=dev)
                mig_ok = mv
                pf_on_g = torch.zeros((G,), dtype=I32, device=dev)
            else:
                homes_ring = _home(ring["page"])
                allowed, mig_ok = link_grants_sharded(
                    ring, now, caps, homes_ring, msrc, mv, msq)
                pf_on_g = _per_shard(homes_ring, allowed, G)
            tier = tier_migrate(tier, mp.reshape(-1), md.reshape(-1),
                                mig_ok.reshape(-1), t)
            migrated_s = mig_ok.sum(1, dtype=I32)
            mig_on_g = _per_shard(msrc, mig_ok, G)
        elif cz is not None:
            caps = (bud_t[t] - d_prev).clamp(min=0)
            allowed = link_grants_sharded(ring, now, caps, _home(ring["page"]))
        elif budget is None:
            allowed = torch.ones(ring["page"].shape, dtype=torch.bool,
                                 device=dev)
        else:
            caps = (budget - d_prev).clamp(min=0)
            allowed = link_grants_sharded(ring, now, caps, _home(ring["page"]))
        # --- wait/serve (metadata only; the copy plan is applied below) ---
        deferred0 = meta["n_deferred"]
        meta, ring, _, slot, _, winfo = pool_wait(meta, ring, None, None,
                                                  pages, now, land_ok=allowed)
        if cz is not None:
            # EWMA update from this step's landings: the realized delay,
            # bucketed per (stream, home shard); column G drops
            lp, li = winfo["landed_pages"], winfo["landed_issued"]
            lmask = lp >= 0
            homes_l = torch.where(lmask, _home(lp), G).long()
            obs = torch.where(lmask, now[:, None] - li, 0).to(I32)
            obs_sum = torch.zeros((S, G + 1), dtype=I32, device=dev
                                  ).scatter_add_(1, homes_l, obs)[:, :G]
            cnt = torch.zeros((S, G + 1), dtype=I32, device=dev
                              ).scatter_add_(1, homes_l, lmask.to(I32))[:, :G]
            est_q = torch.where(cnt > 0,
                                est_step(est_q, obs_sum, cnt.clamp(min=1)),
                                est_q)
        homes_d = _home(pages)
        d_t = ((homes_d[:, None] == shard_ids[None, :])
               & winfo["fetched"][:, None]).sum(0, dtype=I32)
        # --- promote on bytes moved + demand heat ---------------------------
        if mig is not None:
            promoted_s = torch.zeros((S,), dtype=I32, device=dev)
            if mig.compressed:
                # a landing or demand fetch of a compressed page promotes
                # it, counted per stream against the start-of-step snapshot
                lp = winfo["landed_pages"]
                prom_land = winfo["landed"] & comp_pre[
                    lp.clamp(0, n_pages - 1).long()]
                prom_dem = winfo["fetched"] & comp_pre[
                    pages.clamp(0, n_pages - 1).long()]
                promoted_s = (prom_land.sum(1, dtype=I32)
                              + prom_dem.to(I32))
                tier, _ = tier_promote(
                    tier, torch.cat([lp.reshape(-1), pages]),
                    torch.cat([winfo["landed"].reshape(-1),
                               winfo["fetched"]]), comp_pre)
            tier = tier_touch(tier, pages, (pages >= 0) & (pages < n_pages),
                              mig.heat_access)
        # --- controllers + globally ordered, distance-delayed issue ------
        pref_feedback = winfo["prefetched_hit"] | winfo["partial_hit"]
        new_leap, cands, valid = leap_step_batched(
            state["leap"], pages, pref_feedback, n_split=geom.n_split,
            pw_max=geom.pw_max)
        val = valid & (cands >= 0) & (cands < n_pages)
        seq = (t * S + stream_ids)[:, None] * K + cand_ids[None, :]
        homes_c = _home(cands)
        base = torch.where(homes_c == homes_s[:, None],
                           torch.full_like(homes_c, fabric.near_delay),
                           torch.full_like(homes_c, fabric.far_delay))
        if mig is not None and mig.compressed:
            # promote-from-compressed pays the codec on top of the wire
            # (dilation multiplies the wire only)
            base_sur = base + tier["comp"][
                cands.clamp(0, n_pages - 1).long()].to(I32) \
                * mig.decompress_delay
        else:
            base_sur = base
        issued0 = meta["n_prefetch_issued"]
        if cz is None:
            meta, ring = pool_issue(meta, ring, cands, val, now, base_sur,
                                    seq=seq)
        else:
            true_delay = base * dil_t[t][homes_c.long()] + (base_sur - base)
            if chaos.adaptive_deadline:
                eg = torch.gather(est_q, 1, homes_c.long())
                deadline = ((eg + EST_ONE // 2) // EST_ONE).clamp(min=1)
            else:
                deadline = base_sur
            # elastic grant: cap the stream's unconsumed-resident +
            # in-flight footprint; issues beyond the cap are drops
            res_unused = ((meta["slot_page"] >= 0) & meta["slot_prefetched"]
                          & ~meta["slot_consumed"]).sum(1, dtype=I32)
            occ = (ring["page"] >= 0).sum(1, dtype=I32)
            quota = (grant_t[t] - res_unused - occ).clamp(min=0)
            meta, ring = pool_issue(meta, ring, cands, val, now, deadline,
                                    seq=seq, true_delay=true_delay,
                                    quota=quota)
        ring = dict(ring)
        ring["now"] = now + 1
        issued_s = meta["n_prefetch_issued"] - issued0
        deferred_s = meta["n_deferred"] - deferred0
        # --- demote the coldest + propose next step's migrations ------------
        if mig is not None:
            demoted_t = torch.zeros((), dtype=I32, device=dev)
            if mig.compressed:
                dpages, dok = select_demotions(tier, t, mig)
                tier = tier_demote(tier, dpages, dok, t)
                demoted_t = dok.sum(dtype=I32)
            mp2, md2, mv2, msq2 = propose_migrations(
                new_leap, pages, homes_s, tier, t, n_pages, K, mig)
            if cz is not None and t_fail is not None and t >= t_fail:
                mv2 = mv2 & (md2 != dead_g)
            pend = (mp2, md2, mv2, msq2)
            for k, v in (("migrated", migrated_s), ("promoted", promoted_s),
                         ("demoted", demoted_t), ("mig_on", mig_on_g),
                         ("pf_on", pf_on_g)):
                cols[k].append(v)
        # --- data plane: replay the copy plan (landings, then demand) ----
        src = torch.cat([winfo["landed_pages"],
                         torch.where(winfo["fetched"], pages,
                                     torch.full_like(pages, NO_PAGE))[:, None]],
                        1)
        dst = torch.cat([winfo["landed_slots"], slot[:, None]], 1)
        msk = torch.cat([winfo["landed"], winfo["fetched"][:, None]], 1)
        scatter_hot(hot, gather(cold, src), dst, msk)
        served = _tree_map(lambda h: h[stream_ids.long(),
                                       slot.clamp(min=0).long()], hot)
        state = {"leap": new_leap, "pool_meta": meta, "hot": hot,
                 "ring": ring}
        d_prev = d_t
        for k, v in (("sums", _payload_checksum(served)),
                     ("hit", winfo["hit"]),
                     ("pref_hit", winfo["prefetched_hit"]),
                     ("partial_hit", winfo["partial_hit"]),
                     ("fetched", winfo["fetched"]), ("issued", issued_s),
                     ("landed", winfo["landed"].sum(1, dtype=I32)),
                     ("deferred", deferred_s), ("shard_d", d_t),
                     ("link_i", issued_s.sum(dtype=I32)),
                     ("link_def", deferred_s.sum(dtype=I32))):
            cols[k].append(v)
    per = lambda k: torch.stack(cols[k], 1)                   # [S, T]
    shard_d = torch.stack(cols["shard_d"])                    # [T, G]
    info = {"hit": per("hit"), "pref_hit": per("pref_hit"),
            "partial_hit": per("partial_hit"), "fetched": per("fetched"),
            "issued": per("issued"), "landed": per("landed"),
            "deferred": per("deferred"),
            "shard_demand_fetches": shard_d,
            "link_demand_fetches": shard_d.sum(1, dtype=I32),
            "link_prefetch_issued": torch.stack(cols["link_i"]),
            "link_deferred": torch.stack(cols["link_def"])}
    if cz is not None:
        info["est_q"] = est_q                                  # [S, G]
    if mig is not None:
        info["migrated"] = per("migrated")                     # [S, T]
        info["promoted"] = per("promoted")                     # [S, T]
        info["demoted"] = torch.stack(cols["demoted"])         # [T]
        info["mig_on_shard"] = torch.stack(cols["mig_on"])     # [T, G]
        info["pf_on_shard"] = torch.stack(cols["pf_on"])       # [T, G]
        state = dict(state, tier=tier)
    return state, per("sums"), info


def sharded_multi_stream_consume(cold, schedules: torch.Tensor, geom,
                                 fabric: ShardedPoolCfg, mesh=None,
                                 chaos=None, migration=None):
    """Concurrent streams ``schedules int32[S, T]`` over the sharded cold
    pool (``cold``: a tensor or a dict of ``[n_pages, ...]`` leaves in
    page-id order), on the async issue/wait path (``geom.ring_size > 0``).

    Returns ``(state, data_sums [S, T], info)`` as the reference: the
    stream ``info`` columns ``[S, T]``, the per-NIC
    ``shard_demand_fetches [T, n_shards]``, the link totals ``[T]`` and,
    with ``chaos``, the final ``est_q int32[S, n_shards]``. ``migration``
    (a :class:`repro_torch.paging.lifecycle.MigrationCfg`) adds the
    lifecycle's ``info`` keys ``migrated`` / ``promoted`` ``[S, T]``,
    ``demoted [T]``, ``mig_on_shard`` / ``pf_on_shard [T, n_shards]`` (per-NIC
    migration and prefetch grants) and the final tables as
    ``state["tier"]``; ``None`` or ``enabled=False`` is the exact two-tier
    scan.

    ``mesh`` (a DeviceMesh with a ``"fabric"`` dim of ``n_shards`` ranks;
    with ``n_shards > 1``) runs the mesh plane: every rank of the group
    calls this with the same arguments, keeps only its home slice of
    ``cold``, runs the metadata scan replicated and gathers through
    :func:`fabric_ring_gather`; each rank returns the whole result, bitwise
    the flat plane's. The reference memoizes its ``shard_map`` runner per
    topology (``cached_shard_map``); eager PyTorch traces nothing, so there
    is nothing to cache.
    """
    if geom.ring_size <= 0:
        raise ValueError("sharded consume needs the async issue/wait ring "
                         "(geom.ring_size > 0)")
    check_fabric_topology(geom.n_pages, fabric, mesh)
    gather = _gather_flat
    if mesh is not None and fabric.n_shards > 1:
        cold, gather = mesh_plane(cold, geom.n_pages, fabric, mesh)
    return _consume(cold, schedules, geom, fabric, chaos, migration, gather)
