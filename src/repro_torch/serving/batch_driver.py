"""Lock-step batch serving: the fixed-batch tiered replay + chaos sidecar.

Counterpart of ``repro.serving.batch_driver``. Every request
of the batch prefills together, decodes together and finishes together
(``launch/serve.py --arrival batch``). :func:`serve_batch_tiered` then
replays the decode window through the tiered paged-KV data path: it
mirrors the model's real decoded K/V into the cold paged pool and, per
decode step, appends the step's K/V (``append_kv``), invalidates the
written page in every stream's hot tier, sweeps each request's context
pages through its hot pool and serves attention from the hot slots, pinned
**bitwise** against the flat pool every step.

``--shards > 1`` shards the cold pool over home shards: on the mesh
plane when given the fabric mesh (one home slice a rank, pages moving in
a ring; the CLI builds it under ``torchrun --nproc-per-node N``), else on
the flat data plane; the two planes are bitwise equal.
``--chaos`` adds
:func:`chaos_sidecar`, run on the serve's device. The per-step query comes
from a
``torch.Generator`` seeded with ``100 + t`` (the reference draws it with
``jax.random``; the pin compares within one framework, so only the integer
outcomes carry across).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs.export import write_chrome_trace, write_jsonl
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import (Event, decode_sweep_events,
                                   events_to_counts, summary_events)
from repro_torch.paging.kv_cache import (append_kv, init_paged_kv,
                                         linear_page_table,
                                         paged_decode_attention)
from repro_torch.paging.sharded_pool import ShardedPoolCfg
from repro_torch.paging.tiered_kv import (TieredKV, normalize_attn_kernel,
                                          tiered_attention, tiered_init,
                                          tiered_invalidate, tiered_min_slots,
                                          tiered_stats, tiered_sweep)
from repro_torch.serving.executor import synth_kv

#: event-type totals that must reproduce the pool counters exactly
#: whenever a trace is written
PINNED_COUNTERS = ("hits", "misses", "partial_hits", "prefetch_hits",
                   "prefetch_issued", "deferred", "ring_drops", "pollution")


def find_dense_kv(state) -> tuple[torch.Tensor, torch.Tensor] | \
        tuple[None, None]:
    """The first attention layer's dense KV cache of a decode state,
    ``(k, v)`` each ``[B, T, Hkv, dh]`` (a decoder-only model's first
    attention block; an encoder-decoder's self-attention stack ``[L, B,
    T, Hkv, dh]``, layer 0), or ``(None, None)`` for a cache-free model.
    Under a sliding window ``T`` is the rolling buffer's, which the caller
    mirrors as it is (as the reference's)."""
    if not isinstance(state, dict):
        return None, None
    skv = state.get("self_kv")
    if isinstance(skv, dict) and skv["k"].dim() == 5:
        return skv["k"][0], skv["v"][0]
    for b in state.get("blocks", ()):
        if isinstance(b, dict) and "k" in b and "v" in b \
                and b["k"].dim() == 4:
            return b["k"], b["v"]
    return None, None


def serve_batch_tiered(cfg, state, args, B: int, prompt_len: int,
                       max_len: int, reg: Registry | None = None,
                       trace_path: str | None = None, mesh=None) -> dict:
    """Replay the decode window through the tiered paged-KV data path.

    ``args`` carries the CLI's ``page_size``, ``streams``, ``chunk``,
    ``ring_size``, ``async_datapath``, ``link_budget``, ``shards``,
    ``placement``, ``far_delay``, ``chaos``, ``attn_kernel`` and ``gen``.
    With ``trace_path`` the per-sweep info is decoded host-side, after each
    timed window, into the page-lifecycle event log on the global
    chunk-step clock, written as a Chrome trace + JSONL (with the link and,
    sharded, the per-NIC demand counter tracks), and the event-type totals
    are pinned against the final pool counters. ``mesh`` (with ``shards >
    1``) is the fabric DeviceMesh of the mesh plane; ``None`` is the flat
    plane.
    """
    ps = args.page_size
    npps = -(-max_len // ps)
    n_pages = B * npps
    hkv, hq, dh = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
    n_streams = args.streams if args.streams > 1 else B

    kd, vd = find_dense_kv(state)
    if kd is None:
        # cache-free family: synthetic K/V keyed by (request, position),
        # as the synthetic executor's (the reference draws them from
        # PRNGKey(7) / (8); the replay's integers do not read the bytes)
        leaf = next(t for b in state["blocks"] for t in b.values())
        kv = [synth_kv(7, b, 0, max_len, hkv, dh, getattr(torch, cfg.dtype),
                       leaf.device) for b in range(B)]
        kd, vd = (torch.stack([x[i] for x in kv]) for i in (0, 1))
    dev, dtype = kd.device, kd.dtype

    def pad_to(x, T):
        if x.shape[1] >= T:
            return x[:, :T]
        return torch.cat([x, x.new_zeros((B, T - x.shape[1]) + x.shape[2:])],
                         1)

    kd, vd = pad_to(kd, npps * ps), pad_to(vd, npps * ps)
    pt_full = linear_page_table(B, npps, device=dev)

    # cold tier: the prompt prefix now; decode positions are appended step
    # by step inside the replay loop (the real write path)
    pool = init_paged_kv(1, n_pages, ps, hkv, dh, dtype, dev)
    in_prompt = (torch.arange(npps * ps, device=dev) < prompt_len)[
        None, :, None, None]
    for name, x in (("k", kd), ("v", vd)):
        pages = torch.where(in_prompt, x, torch.zeros((), dtype=dtype,
                                                      device=dev))
        pool[name][0, pt_full.reshape(-1).long()] = pages.reshape(
            B * npps, ps, hkv, dh)

    # n_slots from the sweep geometry (the residency floor)
    proto = TieredKV(n_pages, 1, ps, hkv, dh, chunk=args.chunk,
                     ring_size=args.ring_size)
    geom = TieredKV(n_pages, tiered_min_slots(npps, proto), ps, hkv, dh,
                    chunk=args.chunk, ring_size=args.ring_size)
    tstate = tiered_init(geom, n_streams, dtype, dev)
    rows = torch.stack([pt_full[s % B] for s in range(n_streams)])

    fabric = None
    if args.shards > 1:
        if n_pages % args.shards:
            raise SystemExit(f"--shards {args.shards} must divide the "
                             f"{n_pages}-page cold pool")
        fabric = ShardedPoolCfg(n_shards=args.shards,
                                placement=args.placement,
                                link_budget=args.link_budget,
                                near_delay=1, far_delay=args.far_delay)
        # append_kv writes the pool every step, so tiered_sweep takes this
        # rank's home slice anew each call, as the reference re-places the
        # whole pool

    reg = reg if reg is not None else Registry()
    attn_mode = normalize_attn_kernel(getattr(args, "attn_kernel", "ref"))
    n_chunks = -(-npps // geom.chunk)      # global clock: chunk steps
    events = [] if trace_path else None
    link_hist, shard_hist = [], []
    equiv_ok = True
    first_bad_step = None
    deferred = partials = 0
    shard_demand = np.zeros(args.shards, np.int64)
    for t in range(args.gen - 1):
        pos = prompt_len + t
        append_kv(pool, 0, kd[:, pos], vd[:, pos], pt_full, pos)
        written = pt_full[:, pos // ps]                      # [B]
        inv_pages = torch.stack([written[s % B] for s in range(n_streams)])
        tstate = tiered_invalidate(tstate, inv_pages[:, None])
        cold = {"k": pool["k"][0], "v": pool["v"][0]}
        lengths = torch.full((n_streams,), pos + 1, dtype=torch.int32,
                             device=dev)
        gen = torch.Generator(device=dev).manual_seed(100 + t)
        q = torch.randn((n_streams, 1, hq, dh), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        # the timed windows cover only the serving path (sweep +
        # attention); the flat-pool reference, the pin and the host-side
        # event decode all run outside them
        with reg.span("tiered_sweep") as sp:
            tstate, info = tiered_sweep(tstate, cold, rows, geom,
                                        async_datapath=args.async_datapath,
                                        link_budget=args.link_budget,
                                        fabric=fabric, mesh=mesh)
            sp.sync = info
        with reg.span("tiered_attention") as sp:
            tiered, resident = tiered_attention(q, tstate, rows, lengths,
                                                attn_kernel=attn_mode)
            sp.sync = tiered
        flat = paged_decode_attention(q, pool, 0, rows, lengths,
                                      use_kernel=(attn_mode != "ref"))
        step_ok = bool(resident) and torch.equal(tiered, flat)
        if not step_ok and first_bad_step is None:
            first_bad_step = t
        equiv_ok &= step_ok
        info_np = {k: v.cpu().numpy() for k, v in info.items()}
        deferred += int(info_np["deferred"].sum())
        partials += int(info_np["partial_hit"].sum())
        if fabric is not None:
            shard_demand += info_np["shard_demand_fetches"].sum(0)
        if events is not None:
            step0 = t * n_chunks           # each sweep advances the stream
            inv_np = inv_pages.cpu().numpy()  # clock by n_chunks steps
            events.extend(Event("invalidate", step0, s, page=int(inv_np[s]))
                          for s in range(n_streams))
            events.extend(decode_sweep_events(info_np, step_offset=step0))
            link_hist.append(info_np["link_demand_fetches"])
            shard_hist.append(info_np["shard_demand_fetches"])

    per = [tiered_stats(tstate, s) for s in range(n_streams)]
    t_tiered = (reg.histogram("tiered_sweep").total
                + reg.histogram("tiered_attention").total)
    out = {
        "tiered_equiv_ok": equiv_ok,
        "tiered_attn_kernel": attn_mode,
        "tiered_streams": n_streams,
        "tiered_n_slots": geom.n_slots,
        "tiered_hot_frac": round(n_streams * geom.n_slots / n_pages, 3),
        "tiered_decode_s": round(t_tiered, 3),
        "paged_prefetch_hit_rate": round(
            float(np.mean([p["coverage"] for p in per])), 3),
        "paged_pollution": sum(p["pollution"] for p in per),
        "paged_ring_drops": sum(p["ring_drops"] for p in per),
    }
    if args.async_datapath:
        out["paged_partial_hits"] = partials
        out["paged_latency_hidden_frac"] = round(
            float(np.mean([p["latency_hidden_frac"] for p in per])), 3)
    if args.link_budget is not None:
        out["paged_link_budget"] = args.link_budget
        out["paged_deferred"] = deferred
    if args.shards > 1:
        out["paged_shards"] = args.shards
        out["paged_placement"] = args.placement
        out["paged_shard_demand"] = shard_demand.tolist()
    if first_bad_step is not None:
        out["tiered_first_bad_step"] = first_bad_step
    spans = reg.summary()["histograms"]
    out["span_sweep_ms"] = round(spans["tiered_sweep"]["avg"] * 1e3, 3)
    out["span_attention_ms"] = round(spans["tiered_attention"]["avg"] * 1e3, 3)
    if events is not None:
        events.extend(summary_events(per))
        cnts = events_to_counts(events, n_streams)
        totals_ok = all(cnts[s][k] == per[s][k] for s in range(n_streams)
                        for k in PINNED_COUNTERS)
        counters = {"link_demand_fetches": np.concatenate(link_hist)}
        if args.shards > 1:
            counters["shard_demand_fetches"] = np.concatenate(shard_hist)
        write_chrome_trace(trace_path, events, counters)
        write_jsonl(trace_path + ".jsonl", events)
        out["trace_path"] = trace_path
        out["trace_events"] = len(events)
        out["trace_totals_ok"] = totals_ok
    if args.chaos:
        out.update(chaos_sidecar(args, rows, n_pages, n_streams))
    return out


def chaos_sidecar(args, rows: torch.Tensor, n_pages: int,
                  n_streams: int) -> dict:
    """Replay the requests' context-page schedules under a ChaosSpec.

    The sidecar drives the chaos-enabled sharded consume
    (:func:`repro_torch.paging.sharded_pool.sharded_multi_stream_consume`)
    over the same physical pages the tiered path serves, on the device
    ``rows`` lies on: each stream walks its context pages cyclically for
    ``min(max(4 * npps, 48), 256)`` steps while the spec's faults
    (stragglers, budget cuts, node loss, grant churn) hit the fabric. The
    report compares the adaptive-deadline EWMA's per-shard delay estimate
    with the true (dilated) delay at the end of the run.
    """
    from repro_torch.fabric.chaos import EST_ONE, ChaosSpec, compile_chaos
    from repro_torch.paging.prefetch_serving import (PrefetchedStream,
                                                     stream_stats_at)
    from repro_torch.paging.sharded_pool import sharded_multi_stream_consume

    with open(args.chaos) as f:
        spec = ChaosSpec.from_json(f.read())
    G = max(args.shards, 1)
    if n_pages % G:
        raise SystemExit(f"--chaos sidecar: {n_pages}-page pool not "
                         f"divisible by {G} shards")
    npps = rows.shape[1]
    T = min(max(4 * npps, 48), 256)
    scheds = torch.stack([rows[s][torch.arange(T, device=rows.device) % npps]
                          for s in range(n_streams)]).to(torch.int32)
    geom = PrefetchedStream(n_pages=n_pages, n_slots=n_pages, page_elems=4,
                            ring_size=args.ring_size)
    fab = ShardedPoolCfg(n_shards=G, placement=args.placement,
                         link_budget=args.link_budget,
                         near_delay=1, far_delay=args.far_delay)
    cold = torch.arange(n_pages * 4, dtype=torch.float32,
                        device=rows.device).reshape(n_pages, 4)
    st, _, info = sharded_multi_stream_consume(cold, scheds, geom, fab,
                                               chaos=spec)
    per = [stream_stats_at(st, s) for s in range(n_streams)]
    faults = sum(p["faults"] for p in per)
    hits = sum(p["prefetch_hits"] for p in per)
    deferred = sum(p["deferred"] for p in per)
    cz = compile_chaos(spec, n_steps=T, n_streams=n_streams, n_shards=G,
                       n_pages=n_pages, placement=args.placement,
                       base_budget=args.link_budget)
    # final per-shard delay: estimate (stream-averaged EWMA, steps) against
    # the true dilated delay at the last step (stream-averaged near/far)
    est = info["est_q"].cpu().numpy().astype(np.float64) / EST_ONE
    home = np.arange(n_streams) % G
    base = np.where(np.arange(G)[None, :] == home[:, None],
                    1, args.far_delay)
    true = base * np.asarray(cz["dilation"][-1], dtype=np.float64)[None, :]
    return {
        "chaos_spec": args.chaos,
        "chaos_steps": T,
        "chaos_shards": G,
        "chaos_faults": faults,
        "chaos_prefetch_hits": hits,
        "chaos_deferred": deferred,
        "chaos_timely_rate": round((hits - deferred) / max(1, faults), 3),
        "chaos_pollution": sum(p["pollution"] for p in per),
        "chaos_est_delay": [round(float(v), 2) for v in est.mean(0)],
        "chaos_true_delay": [round(float(v), 2) for v in true.mean(0)],
        "chaos_adaptive_deadline": spec.adaptive_deadline,
    }
