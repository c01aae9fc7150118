"""Multi-pod dry run: build and run every (arch x shape x mesh) cell once on
the ``meta`` device, and record its per-rank cost (counterpart of
``repro.launch.dryrun``).

Per cell this script:
  1. builds the step with production shardings (``launch.steps.build_cell``)
     on ``make_production_mesh``'s ``(16, 16)`` or ``(2, 16, 16)`` mesh,
     over torch's fake process group of 256 or 512 ranks (set up in
     :func:`main`, never at import), as this process's rank 0;
  2. runs it on ``meta`` tensors placed as DTensors (shapes, dtypes
     and placements; no storage, no kernel, no device): a run that ends
     proves the sharding rules coherent for the port's step, as the
     reference's lower + compile does for XLA's. A cell with a
     recurrence (Mamba's train scan, the mLSTM and sLSTM) runs it once
     with each time loop cut to one step, then once more for each loop
     with that loop at two (a fresh cell each time);
  3. records this rank's argument and output bytes, exact, from the local
     shards of the placed inputs and outputs; its FLOPs, collectives and
     HBM-write estimate (``launch.op_analysis``), every step of every
     loop counted (a recurrence's by its trip count, ``loop_counts``);
     the step's whole FLOPs; the cell's wall time (``wall_s``);
  4. writes one JSON a cell under ``--out`` with the reference's keys
     (cells already there are skipped unless ``--force``).

The keys only XLA's compiler can give are written ``null`` and named in
the record's ``not_ported`` list, never estimated: ``lower_s`` and
``compile_s`` (nothing is lowered or compiled), ``memory.temp_bytes``,
``memory.alias_bytes`` and ``memory.peak_nonarg_bytes`` (XLA's buffer
assignment), ``cost.transcendentals`` and ``cost.bytes_accessed`` (its
cost analysis). ``loop_counts`` gives each recurrence's trip count and
executions; every other loop runs whole, so ``collectives`` and
``collectives_loop_aware`` are the same tally, every step counted. A host
int of the port's state (the decode state's ``pos``, the train step's
``step``) is not an argument on the device and counts 0 bytes, where the
reference's int32 scalars count 4. The run times no kernel: ``wall_s``
is the host's time to build and count the cell.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2_5_3b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs as cfglib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import analyze_step
from repro_torch.launch.steps import build_cell

#: the record's keys that only XLA's compiler gives
NOT_PORTED = ["lower_s", "compile_s", "memory.temp_bytes",
              "memory.alias_bytes", "memory.peak_nonarg_bytes",
              "cost.transcendentals", "cost.bytes_accessed"]


def local_bytes(tree) -> int:
    """Bytes of this rank's share of every tensor in ``tree`` (dicts,
    lists, tuples): a DTensor's local shard, a plain tensor whole."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    return 0


def _placed_bytes(tree: dict, parts: dict, mesh) -> int:
    """Local bytes of a flat dict of meta tensors once placed by
    ``parts``."""
    from repro_torch.launch.steps import _place
    return sum(local_bytes(_place(v, mesh, parts[k])) for k, v in
               tree.items())


def _world_for(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


def run_cell(arch: str, shape: str, multi_pod: bool,
             smoke: bool = False, loop_aware: bool = True) -> dict:
    """One cell's record, on the production mesh of the process group
    :func:`main` (or a test) started: a fake group of 256 ranks, or 512
    with ``multi_pod``. The recurrences' counts are loop-aware (one step
    and two, scaled: ``op_analysis.analyze_step``), unless
    ``loop_aware=False`` runs every step of them."""
    import torch.distributed as dist
    if dist.get_world_size() != _world_for(multi_pod):
        raise ValueError(f"run_cell: the process group has "
                         f"{dist.get_world_size()} ranks; the "
                         f"{'multi' if multi_pod else 'single'}-pod mesh "
                         f"needs {_world_for(multi_pod)}")
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")

    def fresh():
        c = build_cell(arch, shape, mesh, multi_pod=multi_pod, smoke=smoke)
        return c.step_fn, c.args

    cell = build_cell(arch, shape, mesh, multi_pod=multi_pod, smoke=smoke)
    rec = {"arch": arch, "shape": shape,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "multi_pod": multi_pod, "kind": cell.kind}
    if cell.skip:
        rec["skip"] = cell.skip
        return rec
    sh = cell.shardings
    if cell.kind == "train":
        opt_state, batch, _ = cell.args
        in_batch = _placed_bytes(batch, sh["batch"], mesh)
    elif cell.kind == "prefill":
        (batch,) = cell.args
        in_batch = _placed_bytes(batch, sh["batch"], mesh)
    else:
        token, state = cell.args
        in_batch = _placed_bytes({"token": token}, {"token": sh["token"]},
                                 mesh)
    out, counts = analyze_step(cell.step_fn, *cell.args,
                               fresh=fresh if loop_aware else None)
    params = local_bytes(list(cell.model.parameters()))
    if cell.kind == "train":
        carried = local_bytes(opt_state)          # placed by the step
        args = params + carried + in_batch
        outputs = params + carried + local_bytes(out)
    elif cell.kind == "prefill":
        args = params + in_batch
        outputs = local_bytes(out)                # logits, state
    else:
        args = params + in_batch + local_bytes(state)   # placed in place
        outputs = local_bytes(out)                # next token, state
    rec.update({
        "lower_s": None,
        "compile_s": None,
        "memory": {"argument_bytes": args, "output_bytes": outputs,
                   "temp_bytes": None, "alias_bytes": None,
                   "peak_nonarg_bytes": None},
        "cost": {"flops": counts["flops"], "transcendentals": None,
                 "bytes_accessed": None},
        "collectives": counts["collectives"],
        "collectives_loop_aware": counts["collectives"],
        "hbm_write_bytes": counts["hbm_write_bytes"],
        "loop_counts": counts["loop_counts"],
        "n_chips": math.prod(mesh.shape),
        "flops_global": counts["flops_global"],
        "collectives_comm_debug": counts["collectives_comm_debug"],
        "n_ops": counts["n_ops"],
        "wall_s": time.perf_counter() - t0,
        "not_ported": list(NOT_PORTED),
    })
    return rec


def start_fake_group(multi_pod: bool) -> None:
    """Torch's fake process group of the production mesh's ranks, this
    process rank 0 (no peer, no collective moves a byte)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=_world_for(multi_pod))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = cfglib.ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = (list(cfglib.SHAPES) if (args.all or not args.shape)
              else [args.shape])
    cells = [(a, s) for a in archs for s in shapes]

    os.makedirs(args.out, exist_ok=True)
    start_fake_group(args.multi_pod)
    failures = 0
    try:
        for a, s in cells:
            tag = f"{a}__{s}__{'pod2' if args.multi_pod else 'pod1'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[cached] {tag}")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                rec = run_cell(a, s, args.multi_pod)
            except Exception as e:
                failures += 1
                rec = {"arch": a, "shape": s, "multi_pod": args.multi_pod,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                print(f"  FAILED: {type(e).__name__}: {str(e)[:500]}")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if "memory" in rec:
                gb = rec["memory"]["argument_bytes"] / 2**30
                print(f"  ok: per-rank args={gb:.2f} GiB "
                      f"flops/rank={rec['cost']['flops']:.3g} "
                      f"wall {rec['wall_s']:.1f} s")
            elif "skip" in rec:
                print(f"  skipped: {rec['skip']}")
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
