"""Continuous-batching serving engine over the tiered paged-KV data path.

Counterpart of ``repro.serving.engine``. One engine step admits arrived
requests into free slots, runs prefill chunks and decode tokens (their K/V
written into the cold paged pool), invalidates the written pages in every
stream's hot tier, sweeps the decoding slots' context pages through the
Leap-managed hot pools and pins hot-tier attention **bitwise** against the
flat-pool attention for every active row, then evicts finished requests.

The pin compares like with like: ``attn_kernel="fused"``, ``"fused_async"``
and ``"kernel"`` against the flat kernel, ``"ref"`` against the flat plain
version. The
per-step query comes from a ``torch.Generator`` seeded with ``1000 + t``.
The engine updates its cold pool and tiered state in place between steps.
``shards > 1`` shards the cold pool (``placement``, ``far_delay``, a
per-NIC ``link_budget``). With a fabric ``mesh`` (the serve CLI builds one
when a launcher starts it as ``shards`` ranks) the sweep runs on the mesh
plane: every rank serves the same requests with the same executor, so the
metadata and the tokens are replicated and only the cold pool's bytes are
read from each rank's home slice, moving between ranks in a ring. Without
one it runs on the flat data plane (the reference forces host devices
there).

``migration`` (a :class:`repro_torch.paging.lifecycle.MigrationCfg`) runs
the §12 page lifecycle: a host-side :class:`PageLifecycle` between steps
re-homes each decoding stream's upcoming pages toward its shard along its
Leap trend (scheduling only: budgets, deadlines, per-NIC accounting) and,
with ``compressed``, demotes the coldest pages, whose layer-0 cold bytes
go once through the int8 page codec (their stale hot copies are
invalidated, so the flat and tiered sides read the same post-roundtrip
bytes and the pin holds).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fabric.tenants import ArrivalProcess
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import (Event, RequestPhase, decode_sweep_events,
                                   events_to_counts, summary_events)
from repro_torch.paging.kv_cache import (PageAllocator, init_paged_kv,
                                         paged_decode_attention)
from repro_torch.paging.lifecycle import PageLifecycle, resolve
from repro_torch.paging.sharded_pool import (ShardedPoolCfg,
                                             check_fabric_topology)
from repro_torch.paging.tiered_kv import (TieredKV, normalize_attn_kernel,
                                          tiered_attention, tiered_init,
                                          tiered_invalidate, tiered_min_slots,
                                          tiered_reset_stream, tiered_stats,
                                          tiered_sweep)
from repro_torch.runtime.compression import roundtrip_pages

from .request import DECODE, PREFILL, Request
from .scheduler import AdmissionQueue, SlotScheduler

#: event-type totals pinned against the pool counters when tracing
PINNED_COUNTERS = ("hits", "misses", "partial_hits", "prefetch_hits",
                   "prefetch_issued", "deferred", "ring_drops", "pollution")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static configuration of one continuous-batching serving run (the
    reference's fields). ``migration`` is a ``MigrationCfg``, or ``None``
    / ``enabled=False`` for the exact two-tier engine."""

    requests: int = 8
    slots: int = 4
    prompt_len: int = 32
    gen: int = 16
    length_jitter: float = 0.0
    page_size: int = 4
    prefill_chunk: int = 8
    chunk: int = 4
    ring_size: int = 8
    async_datapath: bool = False
    link_budget: int | None = None
    shards: int = 1
    placement: str = "interleave"
    far_delay: int = 2
    use_kernel: bool = True
    attn_kernel: str = "ref"
    arrival: str = "bursty"
    think_time: float = 1000.0
    burst_len: int = 4
    idle_time: float = 4000.0
    churn_every: int = 3
    churn_downtime: float = 6000.0
    step_us: float = 1000.0
    seed: int = 0
    gang: bool = False
    pool_pages: int | None = None
    trace: bool = False
    migration: object = None

    def arrival_process(self) -> ArrivalProcess:
        return ArrivalProcess(kind=self.arrival, think_time=self.think_time,
                              burst_len=self.burst_len,
                              idle_time=self.idle_time,
                              churn_every=self.churn_every,
                              churn_downtime=self.churn_downtime)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


class ServingEngine:
    """Request-lifecycle serving over the tiered paged-KV data path.

    ``executor`` needs ``begin/end``, ``prefill_chunk``, ``decode`` and the
    ``n_kv_heads / head_dim / dtype`` attributes (``n_q_heads`` optional);
    its K/V may be tensors or numpy arrays. ``device=None`` means CUDA.
    ``mesh`` (with ``shards > 1``) is the fabric DeviceMesh of the mesh
    plane; ``None`` serves the flat plane.
    """

    def __init__(self, config: ServeConfig, executor, device=None,
                 mesh=None):
        c = config
        self.cfg = config
        self.ex = executor
        self.device = resolve_device(device)
        self.npps = -(-(c.prompt_len + c.gen) // c.page_size)
        hkv, dh = executor.n_kv_heads, executor.head_dim
        floor = tiered_min_slots(
            self.npps, TieredKV(1 << 30, 1, c.page_size, hkv, dh,
                                chunk=c.chunk, ring_size=c.ring_size))
        if c.pool_pages is not None and c.pool_pages < floor:
            raise ValueError(f"pool_pages={c.pool_pages} is below the "
                             f"tiered residency floor ({floor} pages)")
        n_pages = max(c.pool_pages or c.slots * self.npps, floor)
        n_pages = -(-n_pages // c.shards) * c.shards      # shardable pool
        self.n_pages = n_pages
        self.allocator = PageAllocator(n_pages)
        self.sched = SlotScheduler(c.slots, self.allocator, c.page_size,
                                   gang=c.gang)
        arrivals = c.arrival_process().arrival_steps(
            c.requests, seed=c.seed, step_us=c.step_us)
        lrng = np.random.default_rng(c.seed + 17)

        def draw(base: int) -> int:
            if c.length_jitter <= 0:
                return base
            lo = max(1, int(round(base * (1 - c.length_jitter))))
            return int(lrng.integers(lo, base + 1))

        self.queue = AdmissionQueue(
            Request(req_id=i, prompt_len=draw(c.prompt_len),
                    gen=draw(c.gen), arrival_step=int(arrivals[i]))
            for i in range(c.requests))
        self.dtype = _torch_dtype(executor.dtype)
        self.hq = getattr(executor, "n_q_heads", hkv)
        self.geom = TieredKV(n_pages, min(floor, n_pages), c.page_size,
                             hkv, dh, chunk=c.chunk, ring_size=c.ring_size,
                             use_kernel=c.use_kernel)
        self.tstate = tiered_init(self.geom, c.slots, self.dtype, self.device)
        self.pool = init_paged_kv(1, n_pages, c.page_size, hkv, dh,
                                  self.dtype, self.device)
        self.fabric = self.mesh = None
        if c.shards > 1:
            self.fabric = ShardedPoolCfg(
                n_shards=c.shards, placement=c.placement,
                link_budget=c.link_budget, near_delay=1,
                far_delay=c.far_delay)
            self.mesh = mesh
        check_fabric_topology(n_pages, self.fabric or ShardedPoolCfg(), mesh)
        self.reg = Registry()
        self.phases: list[RequestPhase] = []
        self.events: list[Event] | None = [] if c.trace else None
        self.link_hist: list[np.ndarray] = []
        self.shard_hist: list[np.ndarray] = []
        self.counter_base = [dict.fromkeys(PINNED_COUNTERS, 0)
                             for _ in range(c.slots)]
        mig = resolve(c.migration)
        self.lifecycle = None if mig is None else PageLifecycle(
            n_pages, max(c.shards, 1), c.placement, mig, self.device)
        self.equiv_ok = True
        self.first_bad_step: int | None = None
        self.occupancy_peak = 0.0
        self._chunk_clock = 0
        self._n_chunks = -(-self.npps // c.chunk)
        self._finished: list[Request] = []

    # -- device helpers ------------------------------------------------------
    def _write_tokens(self, req: Request, k, v, start: int) -> list[int]:
        """Write ``[n, Hkv, dh]`` K/V into the cold pool (in place) at
        positions ``start..start+n-1``; returns the distinct pages."""
        k = torch.as_tensor(k, device=self.device)
        v = torch.as_tensor(v, device=self.device)
        n = k.shape[0]
        pages = [self.sched.page_for_position(req, start + j)
                 for j in range(n)]
        ps = self.cfg.page_size
        pg = torch.tensor(pages, dtype=torch.long, device=self.device)
        off = torch.tensor([(start + j) % ps for j in range(n)],
                           dtype=torch.long, device=self.device)
        self.pool["k"][0, pg, off] = k.to(self.dtype)
        self.pool["v"][0, pg, off] = v.to(self.dtype)
        return sorted(set(pages))

    def _sweep_and_pin(self, t: int, decoding: list[Request]) -> None:
        S, npps = self.cfg.slots, self.npps
        rows = np.full((S, npps), -1, np.int32)
        lengths = np.zeros((S,), np.int32)
        for req in decoding:
            rows[req.slot, :len(req.pages)] = req.pages
            lengths[req.slot] = req.prefilled + req.decoded - 1
        rows_t = torch.from_numpy(rows).to(self.device)
        lengths_t = torch.from_numpy(lengths).to(self.device)
        sweep_kw = {} if self.lifecycle is None else \
            self._drive_lifecycle(rows, decoding)
        cold = {"k": self.pool["k"][0], "v": self.pool["v"][0]}
        gen = torch.Generator(device=self.device).manual_seed(1000 + t)
        q = torch.randn((S, 1, self.hq, self.ex.head_dim), generator=gen,
                        dtype=self.dtype, device=self.device)
        with self.reg.span("tiered_sweep") as sp:
            self.tstate, info = tiered_sweep(
                self.tstate, cold, rows_t, self.geom,
                async_datapath=self.cfg.async_datapath,
                link_budget=self.cfg.link_budget, fabric=self.fabric,
                mesh=self.mesh, **sweep_kw)
            sp.sync = info
        mode = normalize_attn_kernel(self.cfg.attn_kernel)
        with self.reg.span("tiered_attention") as sp:
            tiered, resident = tiered_attention(q, self.tstate, rows_t,
                                                lengths_t, attn_kernel=mode)
            sp.sync = tiered
        flat = paged_decode_attention(q, self.pool, 0, rows_t, lengths_t,
                                      use_kernel=(mode != "ref"))
        act = torch.tensor([r.slot for r in decoding], dtype=torch.long,
                           device=self.device)
        step_ok = bool(resident) and torch.equal(tiered[act], flat[act])
        if not step_ok:
            self.equiv_ok = False
            if self.first_bad_step is None:
                self.first_bad_step = t
        if self.events is not None:
            info_np = {k: v.cpu().numpy() for k, v in info.items()}
            self.events.extend(
                decode_sweep_events(info_np, step_offset=self._chunk_clock))
            self.link_hist.append(info_np["link_demand_fetches"])
            self.shard_hist.append(info_np["shard_demand_fetches"])
        self._chunk_clock += self._n_chunks

    def _drive_lifecycle(self, rows: np.ndarray,
                         decoding: list[Request]) -> dict:
        """One step of the §12 lifecycle on the host, before the sweep:
        decay and heat, hot-ward migration along each decoding stream's
        trend (with more than one shard), then demotion, whose victims'
        layer-0 cold bytes go through the page codec and whose stale hot
        copies are invalidated. Returns the sweep's lifecycle arguments."""
        lc = self.lifecycle
        lc.begin_step()
        lc.touch(rows[rows >= 0])
        G = max(self.cfg.shards, 1)
        if G > 1:
            leap = self.tstate["leap"]
            trend = leap["trend"].cpu().numpy()
            has = leap["has_trend"].cpu().numpy()
            for req in decoding:
                s = req.slot
                if not has[s] or not trend[s]:
                    continue
                frontier = int(req.pages[-1])
                cands = [frontier + int(trend[s])
                         * (self.geom.pw_max + lc.cfg.lead + j)
                         for j in range(lc.cfg.mig_per_stream)]
                moved = lc.migrate_toward(cands, s % G)
                if moved and self.events is not None:
                    self.events.append(Event("migrate", self._chunk_clock,
                                             s, count=moved))
        victims = lc.demote_victims()
        if victims:
            vict = torch.tensor(victims, dtype=torch.int32,
                                device=self.device)
            _roundtrip_pages(self.pool, vict.long())
            self.tstate = tiered_invalidate(
                self.tstate, vict[None].expand(self.cfg.slots, len(victims)))
            if self.events is not None:
                self.events.append(Event("demote", self._chunk_clock, 0,
                                         count=len(victims)))
        kw = {"home_map": lc.home_map()}
        if lc.cfg.compressed:
            kw["comp_map"] = lc.comp_map()
            kw["decompress_delay"] = lc.cfg.decompress_delay
        return kw

    # -- one engine step -----------------------------------------------------
    def _step(self, t: int) -> None:
        for req in self.sched.admit_ready(self.queue, t):
            self.ex.begin(req)
            self.phases.append(RequestPhase("admit", req.req_id,
                                            req.arrival_step, t, req.slot))
        written: list[tuple[int, int]] = []
        decoding: list[Request] = []
        finishers: list[Request] = []
        for req in sorted(self.sched.active(), key=lambda r: r.slot):
            if req.state == PREFILL:
                n = min(self.cfg.prefill_chunk,
                        req.prompt_len - req.prefilled)
                with self.reg.span("prefill_chunk") as sp:
                    k, v, tok = self.ex.prefill_chunk(req, n)
                    sp.sync = k
                pages = self._write_tokens(req, k, v, req.prefilled)
                written.extend((req.slot, p) for p in pages)
                req.advance_prefill(n, t)
                self.phases.append(RequestPhase("prefill_chunk", req.req_id,
                                                t, t + 1, req.slot, n))
                if req.state == DECODE:
                    self.reg.histogram("ttft_steps").observe(req.ttft_steps)
                    if req.decoded >= req.gen:
                        finishers.append(req)
            elif req.state == DECODE:
                pos = req.prefilled + req.decoded - 1
                with self.reg.span("token_latency") as sp:
                    k, v, tok = self.ex.decode(req)
                    sp.sync = k
                pages = self._write_tokens(req, k[None], v[None], pos)
                written.extend((req.slot, p) for p in pages)
                done = req.advance_decode(t)
                decoding.append(req)
                if done:
                    finishers.append(req)
        if written and self.lifecycle is not None:
            # freshly written bytes are uncompressed: clear the bit (a
            # recycled page would otherwise pay the decompress surcharge on
            # stale state)
            n_prom = self.lifecycle.promote([p for _, p in written])
            if n_prom and self.events is not None:
                self.events.append(Event("promote", self._chunk_clock, 0,
                                         count=n_prom))
        if written:
            # the reference pads this list with -1 to a fixed width; -1
            # entries are no-ops, so only the written pages are passed
            inv = torch.tensor([p for _, p in written], dtype=torch.int32,
                               device=self.device)
            inv = inv[None].expand(self.cfg.slots, len(written))
            self.tstate = tiered_invalidate(self.tstate, inv)
            if self.events is not None:
                self.events.extend(
                    Event("invalidate", self._chunk_clock, s, page=p,
                          seq=self.allocator.stamp_of(p))
                    for s, p in written)
        if decoding:
            self._sweep_and_pin(t, decoding)
        self.occupancy_peak = max(self.occupancy_peak,
                                  self.allocator.occupancy())
        for req in finishers:
            self._evict(req, t)

    def _evict(self, req: Request, t: int) -> None:
        self.phases.append(RequestPhase("decode", req.req_id,
                                        req.first_token_step, t, req.slot,
                                        req.decoded))
        slot = req.slot
        stats = tiered_stats(self.tstate, slot)
        base = self.counter_base[slot]
        for key in PINNED_COUNTERS:
            base[key] += int(stats[key])
        tiered_reset_stream(self.tstate, slot, self.geom, self.dtype)
        self.sched.finish(req, t)
        self.ex.end(req)
        self._finished.append(req)
        self.phases.append(RequestPhase("evict", req.req_id, t, t, slot))

    # -- run -----------------------------------------------------------------
    def run(self) -> dict:
        c = self.cfg
        last_arrival = max((r.arrival_step for r in self.queue._pending),
                           default=0)
        per_req = -(-c.prompt_len // c.prefill_chunk) + c.gen + 2
        max_steps = last_arrival + (c.requests + 1) * per_req + 10
        t = 0
        t0 = time.perf_counter()
        while len(self.queue) or self.sched.active():
            if t > max_steps:
                raise RuntimeError(
                    f"engine livelock: {len(self.queue)} queued / "
                    f"{len(self.sched.active())} active after {t} steps")
            with self.reg.span("engine_step") as sp:
                self._step(t)
                sp.sync = self.tstate["pool_meta"]["clock"]
            t += 1
        wall = time.perf_counter() - t0
        return self._report(t, wall)

    def _report(self, steps: int, wall: float) -> dict:
        c = self.cfg
        totals = []
        for s in range(c.slots):
            cur = tiered_stats(self.tstate, s)
            totals.append({k: self.counter_base[s][k] + int(cur[k])
                           for k in PINNED_COUNTERS})
        trace_totals_ok = True
        if self.events is not None:
            self.events.extend(summary_events(totals))
            cnts = events_to_counts(self.events, c.slots)
            trace_totals_ok = all(
                cnts[s][k] == totals[s][k]
                for s in range(c.slots) for k in PINNED_COUNTERS)
        rnd = lambda d: {k: round(v, 5) if isinstance(v, float) else v
                         for k, v in d.items()}
        ttfts = self.reg.histogram("ttft_steps")
        out = {
            "requests": c.requests,
            "slots": c.slots,
            "arrival": c.arrival,
            "admission": "gang" if c.gang else "continuous",
            "steps": steps,
            "wall_s": round(wall, 3),
            "tiered_equiv_ok": self.equiv_ok,
            "requests_finished": len(self._finished),
            "tokens_decoded": sum(r.decoded for r in self._finished),
            "ttft_steps": rnd(ttfts.ladder()),
            "mean_ttft_steps": round(float(np.mean(ttfts.samples)), 3)
            if ttfts.samples else float("nan"),
            "token_latency": rnd(self.reg.histogram("token_latency").ladder()),
            "pages_allocated": self.sched.pages_allocated,
            "pages_recycled": self.sched.pages_recycled,
            "alloc_in_use_end": self.allocator.in_use,
            "alloc_occupancy_peak": round(self.occupancy_peak, 3),
            "prefetch_hits_total": sum(tt["prefetch_hits"] for tt in totals),
            "deferred_total": sum(tt["deferred"] for tt in totals),
        }
        if self.first_bad_step is not None:
            out["tiered_first_bad_step"] = self.first_bad_step
        if self.events is not None:
            out["trace_totals_ok"] = trace_totals_ok
            out["trace_events"] = len(self.events)
        if c.shards > 1:
            out["shards"] = c.shards
            out["placement"] = c.placement
        if self.lifecycle is not None:
            out["residency"] = self.lifecycle.report()
        return out


def _roundtrip_pages(pool: dict, pages: torch.Tensor) -> None:
    """Demotion's lossy int8 round trip of layer 0's ``pages`` (one scale a
    page), in place."""
    for buf in (pool["k"], pool["v"]):
        buf[0, pages] = roundtrip_pages(buf[0, pages])


def serve_continuous(config: ServeConfig, executor=None, arch: str = None,
                     smoke: bool = True, device=None) -> dict:
    """Build an executor (real model or synthetic), run the engine once.

    ``arch=None`` uses the synthetic executor — real scheduling, paging
    and pins over hashed K/V bytes.
    """
    if executor is None:
        executor = build_executor(arch, smoke=smoke, seed=config.seed,
                                  device=device)
    return ServingEngine(config, executor, device=device).run()


def build_executor(arch: str | None, smoke: bool = True, seed: int = 0,
                   device=None):
    """The real :class:`ModelExecutor` for ``arch`` (its smoke config with
    ``smoke``), or :class:`SyntheticExecutor` for ``None``."""
    from repro_torch import configs as cfglib

    from .executor import ModelExecutor, SyntheticExecutor

    if arch is None:
        return SyntheticExecutor(n_kv_heads=2, head_dim=8, seed=seed,
                                 device=device)
    cfg = cfglib.get_smoke_config(arch) if smoke else cfglib.get_config(arch)
    return ModelExecutor(cfg, seed=seed, device=device)
