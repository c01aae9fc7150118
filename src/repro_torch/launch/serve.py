"""Serving CLI of the port: ``repro.launch.serve``.

Two serving disciplines, as in the reference:

* ``--arrival batch`` (default) — the lock-step loop: prefill the whole
  batch, greedy-decode ``--gen`` tokens, and with ``--paged`` replay the
  decode window through the tiered paged-KV data path
  (:func:`repro_torch.serving.batch_driver.serve_batch_tiered`) with the
  tiered/flat bitwise pin every step.
* ``--arrival constant|bursty|churn`` — the continuous-batching engine
  (:class:`repro_torch.serving.engine.ServingEngine`) through
  ``ModelExecutor``, or the synthetic executor with ``--synthetic``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v01_52b \\
      --smoke --device cpu --batch 2 --prompt-len 16 --gen 4 --paged \\
      --async-datapath --attn-kernel fused-async --page-size 4
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --arrival bursty --paged --async-datapath --attn-kernel fused-async \\
      --trace t.json

Serves ``--arch`` (default qwen2.5-3b; ``--smoke`` picks its small
config, ``--layers`` cuts its depth). Runs on the GPU unless ``--device
cpu`` is given. Exits non-zero on a tiered/flat pin break, with
``--trace`` on trace totals that diverge from the pool counters, and on
the continuous path on unfinished requests, a page leak or a
page-conservation break. ``--shards N`` shards the cold pool over N home
shards (``--placement``, ``--far-delay``, a per-NIC ``--link-budget``);
``--chaos SPEC.json`` adds the batch path's chaos sidecar. Run alone, the
shards share one process and the flat data plane. Under a launcher that
sets ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` with N ranks (``torchrun
--nproc-per-node N ... --shards N``) the CLI starts the process group
(NCCL with a card a rank, else gloo: ranks that share a card stage each
ring hop through host memory) and the sweep runs on the mesh plane: each
rank serves the same requests, holds one home slice of the cold pool and
checks its own pin; rank 0 alone prints the report and writes the
trace. On the continuous path ``--migration`` turns on the §12 page
lifecycle (hot-ward migration, ``--mig-cooldown``) and ``--compressed-tier
N`` its compressed cold tier; the report then carries ``residency``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba_v01_52b \
      --smoke --device cpu --batch 2 --prompt-len 16 --gen 4 --paged \
      --async-datapath --page-size 4 --shards 4 --placement interleave \
      --far-delay 2 --link-budget 2 --chaos spec.json
  PYTHONPATH=src python -m repro_torch.launch.serve --synthetic \
      --device cpu --arrival bursty --paged --async-datapath --shards 4 \
      --migration --compressed-tier 16
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --synthetic --device cpu --arrival bursty --paged --async-datapath \
      --shards 4
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_fabric_mesh
from repro_torch.models.model import build_model
from repro_torch.obs.export import (write_chrome_trace, write_jsonl,
                                    write_request_jsonl)
from repro_torch.obs.metrics import Registry
from repro_torch.paging.lifecycle import MigrationCfg
from repro_torch.paging.tiered_kv import normalize_attn_kernel
from repro_torch.runtime.straggler import StepTimeMonitor
from repro_torch.serving.batch_driver import serve_batch_tiered
from repro_torch.serving.engine import (ServeConfig, ServingEngine,
                                        build_executor)
from repro_torch.serving.executor import ModelExecutor

ARRIVALS = ("batch", "constant", "bursty", "churn")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's small config instead of its full one")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the config's first N layers (a depth cut; "
                         "widths unchanged), e.g. 8 for one Jamba block "
                         "of jamba_v01_52b, whose 32 layers do not fit "
                         "one card")
    ap.add_argument("--arrival", choices=ARRIVALS, default="batch",
                    help="'batch' = the lock-step full-batch loop; the rest "
                         "drive the continuous engine with that arrival "
                         "process")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch: requests prefilled and decoded together")
    ap.add_argument("--streams", type=int, default=1,
                    help="batch, with --paged: page streams (stream s "
                         "sweeps request s %% batch); 1 = one per request")
    ap.add_argument("--shards", type=int, default=1,
                    help="with --paged: shard the cold paged-KV pool over "
                         "this many home shards, each behind its own NIC "
                         "(DESIGN.md §7); in one process the flat data "
                         "plane moves the bytes, under torchrun with this "
                         "many ranks a ring between the ranks' home "
                         "slices. Default 1 = flat cold pool")
    ap.add_argument("--placement", choices=("block", "interleave"),
                    default="interleave",
                    help="with --shards: page -> home-shard policy "
                         "(interleave spreads consecutive pages across "
                         "NICs; block keeps contiguous ranges together)")
    ap.add_argument("--far-delay", type=int, default=2,
                    help="with --shards: prefetch arrival delay in chunk "
                         "steps for cross-shard pages (near pages take 1)")
    ap.add_argument("--chaos", default=None, metavar="SPEC.json",
                    help="with --paged: inject faults from a ChaosSpec JSON "
                         "file (DESIGN.md §9) into a chaos sidecar run over "
                         "the requests' context-page schedules — per-shard "
                         "slowdown, NIC budget degradation, node loss with "
                         "page re-homing, elastic tenant grants. Reports "
                         "per-shard estimated vs true delay (the adaptive-"
                         "deadline EWMA) plus timely-hit counters")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=None,
                    help="continuous engine: concurrent serving slots "
                         "(default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens consumed per engine step per slot")
    ap.add_argument("--chunk", type=int, default=4,
                    help="context pages demanded per sweep step")
    ap.add_argument("--ring-size", type=int, default=8,
                    help="in-flight ring capacity for --async-datapath")
    ap.add_argument("--length-jitter", type=float, default=0.0)
    ap.add_argument("--think-time", type=float, default=1000.0,
                    help="continuous engine: arrival-process mean gap (µs)")
    ap.add_argument("--gang", action="store_true",
                    help="continuous engine: lock-step gang admission "
                         "(the fixed-batch baseline) instead of continuous")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="continuous engine: cold-pool pages (default "
                         "slots * pages-per-request; smaller values make "
                         "admission wait on memory)")
    ap.add_argument("--link-budget", type=int, default=None,
                    help="pages/step the shared link moves across all "
                         "streams' prefetches (demand first); with "
                         "--shards > 1 the budget is per shard NIC")
    ap.add_argument("--paged", action="store_true",
                    help="batch: replay the decode window through the "
                         "tiered paged-KV path, pinned to the flat pool; "
                         "the continuous engine always serves through it")
    ap.add_argument("--async-datapath", action="store_true",
                    help="sweep through the issue/wait in-flight ring")
    ap.add_argument("--attn-kernel", default="ref",
                    choices=("ref", "kernel", "fused", "fused-async"),
                    help="decode-attention consumer (fused / fused-async "
                         "read the hot slots in place through the hot-slot "
                         "kernel; fused-async double-buffers its page "
                         "tiles with cp.async)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write the page-lifecycle and request events as a "
                         "Chrome trace (Perfetto-loadable) plus .jsonl and "
                         ".requests.jsonl siblings")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic executor (hashed K/V, no model)")
    # -- three-tier page lifecycle (DESIGN.md §12) ---------------------------
    ap.add_argument("--migration", action="store_true",
                    help="continuous engine: online hot/cold page migration "
                         "(DESIGN.md §12). The Leap trend re-homes each "
                         "stream's upcoming pages toward its shard between "
                         "steps; re-homing steers budgets/deadlines/NIC "
                         "accounting only (the data plane is unchanged, so "
                         "all bit-identity pins keep holding). The report "
                         "gains a per-tier residency section")
    ap.add_argument("--compressed-tier", type=int, default=None,
                    metavar="PAGES",
                    help="continuous engine: cap the *uncompressed* far "
                         "tier at PAGES; the coldest pages beyond it are "
                         "demoted through the lossy int8 page codec (one "
                         "roundtrip at demote time) and pay a decompress "
                         "surcharge on promote. Implies --migration")
    ap.add_argument("--mig-cooldown", type=int, default=16,
                    help="with --migration: hysteresis window in steps — a "
                         "page neither re-homes nor demotes again within "
                         "this many steps of its last tier transition")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    return ap


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _launched_ranks(args) -> bool:
    """Start the process group when a launcher (``torchrun``) set
    ``WORLD_SIZE`` > 1: NCCL when every rank of the node has a card of
    its own, else gloo; ``LOCAL_RANK`` picks this rank's card. Returns
    whether it started one."""
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return False
    backend = "gloo"
    if resolve_device(args.device).type == "cuda":
        n = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % n)
        if n >= int(os.environ.get("LOCAL_WORLD_SIZE", world)):
            backend = "nccl"
    dist.init_process_group(backend)
    return True


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and args.shards != world:
        ap.error(f"{world} ranks serve a cold pool of as many home shards: "
                 f"pass --shards {world}")
    if args.trace and not (args.paged or args.arrival != "batch"):
        ap.error("--trace requires --paged (only the tiered data path "
                 "emits the page-lifecycle info arrays)")
    if args.chaos and not args.paged:
        ap.error("--chaos requires --paged")
    if (args.migration or args.compressed_tier is not None) \
            and args.arrival == "batch":
        ap.error("--migration/--compressed-tier need the continuous engine "
                 "(--arrival constant|bursty|churn): the page lifecycle is "
                 "driven between engine steps")
    started = _launched_ranks(args)
    try:
        # one rank a home shard: the sweep runs on the mesh plane
        mesh = make_fabric_mesh(world) if world > 1 else None
        if args.arrival == "batch":
            return _main_batch(args, mesh=mesh)
        return _main_continuous(args, mesh=mesh)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def model_config(args):
    """``--arch`` (its smoke config with ``--smoke``), cut to ``--layers``."""
    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def _prompts(seed: int, B: int, prompt_len: int, vocab: int) -> torch.Tensor:
    """``int64 [B, prompt_len]`` from a CPU generator seeded ``seed + 1``
    (the reference draws them with ``jax.random``)."""
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randint(0, vocab, (B, prompt_len), generator=g)


def _frames(seed: int, B: int, prompt_len: int, d: int) -> torch.Tensor:
    """An encoder-decoder's stub frames ``float32 [B, prompt_len, d]``,
    standard normals from a CPU generator seeded ``seed + 1`` (the
    reference draws them from the prompts' key)."""
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randn((B, prompt_len, d), generator=g)


def _main_batch(args, model=None, prompts=None, frames=None,
                mesh=None) -> dict:
    """The lock-step path: batched prefill + greedy decode (+ the tiered
    replay). ``model`` (a built model, for example of a depth-cut config)
    and ``prompts`` (``[batch, prompt_len]``) may be handed in, and for an
    encoder-decoder its ``frames`` (``[batch, prompt_len, d_model]``); by
    default the model of ``--arch`` is built with parameters from
    ``--seed`` and the prompts and frames come from ``--seed + 1``.
    ``mesh`` (the fabric mesh, with ``--shards``) takes the tiered replay's
    sweep onto the mesh plane. The result carries the reference's keys
    plus the emitted ``tokens``."""
    dev = resolve_device(args.device)
    if model is None:
        model = build_model(model_config(args), device=dev, seed=args.seed)
    cfg = model.cfg
    B, prompt_len = args.batch, args.prompt_len
    max_len = prompt_len + args.gen
    if prompts is None:
        prompts = _prompts(args.seed, B, prompt_len, cfg.vocab_size)
    if not torch.is_tensor(prompts):
        prompts = torch.tensor(np.asarray(prompts))
    prompts = prompts.long().to(model.device)
    if prompts.shape != (B, prompt_len):
        raise ValueError(f"prompts of shape {tuple(prompts.shape)}, "
                         f"expected ({B}, {prompt_len})")

    extra = {}
    if cfg.family == "encdec":
        if frames is None:
            frames = _frames(args.seed, B, prompt_len, cfg.d_model)
        if not torch.is_tensor(frames):
            frames = torch.from_numpy(np.array(frames, np.float32))
        extra["frames"] = frames.to(device=model.device, dtype=model.dtype)

    reg = Registry()
    with reg.span("prefill") as sp:
        logits, state = model.prefill(prompts, max_len, **extra)
        tok = torch.argmax(logits, -1)
        sp.sync = tok
    t_prefill = reg.histogram("prefill").samples[-1]

    out = [tok]
    mon = StepTimeMonitor()
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        with reg.span("token_latency") as sp:
            logits, state = model.decode_step(tok, state)
            tok = torch.argmax(logits, -1)
            sp.sync = tok
        mon.record(reg.histogram("token_latency").samples[-1])
        out.append(tok)
    t_decode = time.perf_counter() - t0
    tokens = torch.stack(out, 1).cpu()
    rnd = lambda d: {k: round(v, 5) if isinstance(v, float) else v
                     for k, v in d.items()}
    result = {
        "prefill_s": round(t_prefill, 3),
        # TTFT: the first token is emitted by prefill's final logits
        "ttft_s": round(t_prefill, 3),
        "decode_tok_per_s": round(B * (args.gen - 1) / max(t_decode, 1e-9),
                                  1),
        "token_latency": rnd(reg.histogram("token_latency").ladder()),
        "tokens_shape": list(tokens.shape),
        "tokens": tokens.tolist(),
        "step_time_monitor": rnd(mon.summary()),
    }
    trace = args.trace if _rank() == 0 else None
    if args.paged:
        result.update(serve_batch_tiered(cfg, state, args, B, prompt_len,
                                         max_len, reg=reg, trace_path=trace,
                                         mesh=mesh))
        if not result["tiered_equiv_ok"]:
            print(result)
            raise SystemExit("tiered/flat decode attention mismatch (first "
                             "bad decode step "
                             f"{result['tiered_first_bad_step']})")
        if trace and not result["trace_totals_ok"]:
            print(result)
            raise SystemExit("trace event totals diverge from pool counters")
    if _rank() == 0:
        print(result)
    return result


def _main_continuous(args, mesh=None) -> dict:
    """The continuous-batching engine over the request lifecycle, its sweep
    on the mesh plane when ``mesh`` (the fabric mesh) is given."""
    migration = None
    if args.migration or args.compressed_tier is not None:
        migration = MigrationCfg(
            cooldown=args.mig_cooldown,
            compressed=args.compressed_tier is not None,
            far_capacity=args.compressed_tier)
    scfg = ServeConfig(
        requests=args.requests,
        slots=args.slots if args.slots is not None else args.batch,
        prompt_len=args.prompt_len, gen=args.gen,
        length_jitter=args.length_jitter, page_size=args.page_size,
        prefill_chunk=args.prefill_chunk, chunk=args.chunk,
        ring_size=args.ring_size, async_datapath=args.async_datapath,
        link_budget=args.link_budget, shards=args.shards,
        placement=args.placement, far_delay=args.far_delay,
        attn_kernel=normalize_attn_kernel(args.attn_kernel),
        arrival=args.arrival, think_time=args.think_time, seed=args.seed,
        gang=args.gang, pool_pages=args.pool_pages, trace=bool(args.trace),
        migration=migration)
    executor = (build_executor(None, seed=args.seed, device=args.device)
                if args.synthetic else
                ModelExecutor(model_config(args), seed=args.seed,
                              device=args.device))
    engine = ServingEngine(scfg, executor, device=args.device, mesh=mesh)
    result = engine.run()
    if args.trace and _rank() == 0:
        counters = None
        if engine.link_hist:
            counters = {"link_demand_fetches":
                        np.concatenate(engine.link_hist)}
            if args.shards > 1:
                counters["shard_demand_fetches"] = np.concatenate(
                    engine.shard_hist)
        write_chrome_trace(args.trace, engine.events, counters,
                           request_phases=engine.phases)
        write_jsonl(args.trace + ".jsonl", engine.events)
        write_request_jsonl(args.trace + ".requests.jsonl", engine.phases)
        result["trace_path"] = args.trace
    if not result["tiered_equiv_ok"]:
        print(result)
        raise SystemExit("tiered/flat decode attention mismatch under "
                         "continuous batching (first bad step "
                         f"{result.get('tiered_first_bad_step')})")
    if result["requests_finished"] != args.requests:
        print(result)
        raise SystemExit(f"{result['requests_finished']}/{args.requests} "
                         "requests finished")
    if result["alloc_in_use_end"] != 0:
        print(result)
        raise SystemExit(f"page leak: {result['alloc_in_use_end']} pages "
                         "still allocated after drain")
    if result["pages_allocated"] != result["pages_recycled"]:
        print(result)
        raise SystemExit("page conservation violated: "
                         f"{result['pages_allocated']} allocated vs "
                         f"{result['pages_recycled']} recycled")
    if args.trace and not result["trace_totals_ok"]:
        print(result)
        raise SystemExit("trace event totals diverge from pool counters")
    if _rank() == 0:
        print(result)
    return result


if __name__ == "__main__":
    main()
