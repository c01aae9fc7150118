"""End-to-end trainer of the port (``repro.launch.train``).

Wires together the model of ``--arch`` (trainable), the synthetic / memmap
token pipeline, AdamW / Adafactor over a cosine schedule, the eager train
step (``steps.make_train_step``), async checkpointing with
restart-on-failure (``runtime.run_with_restarts``), the straggler monitor
and the watchdog. The flags are the reference CLI's ten, with its
defaults, plus the port's ``--device`` (default ``cuda``) and
``--layers`` (a depth cut, a multiple of the config's scan period).

The run is deterministic on both devices: ``main`` turns on
``torch.use_deterministic_algorithms`` for its duration (restored after),
so a kill and a restore from the last checkpoint give losses bit for bit
those of an uninterrupted run, on the card too: the embedding's
backward, the MoE dispatch's index writes and the CE's gather then avoid
atomics. On the card those algorithms ask for
``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which cuBLAS reads when the
process makes its first handle: this module's entry point sets it when
it is unset, and a program that calls ``main`` on the card sets it at
its own start.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \\
      --smoke --device cpu --steps 12 --global-batch 4 --seq-len 16 \\
      --ckpt-dir "$(mktemp -d)" --save-every 4

With a ``--ckpt-dir`` that holds checkpoints of the same model, the run
resumes from the last one; when that one is step ``--steps`` no step is
left and ``final_loss`` is None.

``main`` returns the reference's ``{"final_loss", "history",
"monitor"}`` and a ``"timing"`` of its own: each step's seconds (``step_s``,
synchronised: reading the loss waits for the device) and the
checkpoint's: each save's host copy, which the step waits for
(``save_s``), and the wait for the last write at the end
(``final_wait_s``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time

import torch

from repro_torch import configs as cfglib
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.data import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import OPT_FOR_ARCH, make_train_step
from repro_torch.models import build_model
from repro_torch.optim import cosine_warmup, make_optimizer, param_tree
from repro_torch.runtime import StepTimeMonitor, Watchdog, run_with_restarts


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--watchdog-s", type=float, default=300.0)
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the config's first N layers (a depth cut; "
                         "widths unchanged), a multiple of its scan period")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs on the host)")
    return ap


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms for the block, the previous setting
    restored after (on CUDA they need ``CUBLAS_WORKSPACE_CONFIG``, set by
    the process's entry point). Uninitialised memory is not
    filled (the mode's default fills every new tensor, a launch each):
    determinism does not need it, since no step reads memory it has not
    written."""
    prev = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    if args.layers is not None:
        P = cfg.scan_period()
        if args.layers <= 0 or args.layers % P:
            ap.error(f"--layers must be a positive multiple of {cfg.name}'s "
                     f"scan period {P}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dev = resolve_device(args.device)
    with deterministic(dev):
        return _train(args, cfg, dev)


def _train(args, cfg, dev: torch.device) -> dict:
    model = build_model(cfg, device=dev, seed=None, trainable=True)
    opt_name = OPT_FOR_ARCH.get(cfglib.canonical(args.arch), "adamw")
    opt_init, opt_update = make_optimizer(
        opt_name, cosine_warmup(args.lr, 10, args.steps))
    opt_state = opt_init(param_tree(model))
    pipe = make_pipeline(cfg.vocab_size, args.global_batch, args.seq_len)
    train_step = make_train_step(model, opt_update)
    save_s: list = []

    ck = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    monitor = StepTimeMonitor()
    watchdog = Watchdog(args.watchdog_s).start()
    history: list[float] = []
    # the checkpointed tree: the parameters (state_dict tensors share
    # their storage, so a restore writes into the model) and the moments
    state = {"params": model.state_dict(), "opt": opt_state}

    @torch.no_grad()
    def make_state():
        model.init_params(torch.Generator(device=dev).manual_seed(0))
        for _, t in flatten(opt_state):
            t.zero_()
        return state

    def one(state, step):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.peek(step).items()}
        loss, gn = train_step(state["opt"], batch, step)
        loss = float(loss)
        history.append(loss)
        watchdog.beat()
        if monitor.record(time.perf_counter() - t0):
            print(f"[straggler] step {step} took "
                  f"{time.perf_counter() - t0:.2f}s (ewma {monitor.ewma:.2f})")
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(gn):.3f}")
        return state

    def save(state, step):
        if ck:
            t0 = time.perf_counter()
            ck.save(step, state, {"data_step": step})
            save_s.append(time.perf_counter() - t0)

    def restore():
        if not ck:
            return None
        ck.wait()           # a save still being written commits first
        s = latest_step(args.ckpt_dir)
        if s is None:
            return None
        _, extras = restore_checkpoint(args.ckpt_dir, s, state)
        pipe.load_state_dict({"step": extras.get("data_step", s)})
        return state, s

    try:
        _, restarts = run_with_restarts(make_state, one, save, restore,
                                        args.steps, args.save_every)
        t0 = time.perf_counter()
        if ck:
            ck.wait()
        wait_s = time.perf_counter() - t0
    finally:
        watchdog.stop()
    final = history[-1] if history else None   # restored at step --steps
    shown = "none (no step left)" if final is None else f"{final:.4f}"
    print(f"done: final loss {shown} "
          f"(restarts={restarts}, stragglers={monitor.flags})")
    return {"final_loss": final, "history": history,
            "monitor": monitor.summary(),
            "timing": {"step_s": list(monitor.history),
                       "save_s": save_s, "final_wait_s": wait_s}}


if __name__ == "__main__":
    # before the first cuBLAS handle: the deterministic algorithms ask for it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    main()
