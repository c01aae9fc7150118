"""Port: the lock-step batch driver and the batch CLI against the reference.

``serve_batch_tiered`` runs in both frameworks on the same dense KV cache
(drawn from a numpy seed; jamba smoke geometry, one attention layer among
Mamba layers). The page-lifecycle event log — every sweep's info columns,
decoded per chunk step, the invalidations and the end-of-run counters —
must be identical, as must the integer report keys, the pin
(``tiered_equiv_ok``) and the trace totals. The reference's async gather
kernel does not run on this JAX (ROADMAP queue 3), so its async run moves
the same bytes through its plain gather (``TieredKV(use_kernel=False)``).
"""

import functools
import json
import os
import pathlib
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving.batch_driver as jbd  # noqa: E402
from repro import configs as jcfg  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import batch_driver as tbd  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, P, G = 2, 16, 4
EXACT = ("tiered_equiv_ok", "tiered_attn_kernel", "tiered_streams",
         "tiered_n_slots", "tiered_hot_frac", "paged_prefetch_hit_rate",
         "paged_pollution", "paged_ring_drops", "paged_partial_hits",
         "paged_latency_hidden_frac", "paged_link_budget", "paged_deferred",
         "trace_events", "trace_totals_ok")


def _args(**kw):
    base = dict(page_size=4, streams=1, chunk=2, ring_size=4, shards=1,
                placement="interleave", link_budget=None, far_delay=2,
                attn_kernel="ref", gen=G, async_datapath=False, chaos=None)
    return types.SimpleNamespace(**(base | kw))


def _events(path):
    with open(path + ".jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("mode", [
    pytest.param(dict(attn_kernel="ref", link_budget=2), id="sync-budget"),
    pytest.param(dict(attn_kernel="fused", async_datapath=True),
                 id="async-fused"),
])
def test_batch_driver_matches_the_reference(monkeypatch, tmp_path, mode):
    cfg = jcfg.get_smoke_config("jamba_v01_52b")
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal((B, P + G, cfg.n_kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2))
    monkeypatch.setattr(jbd, "TieredKV",
                        functools.partial(jbd.TieredKV, use_kernel=False))
    jstate = {"blocks": ({}, {"k": jnp.asarray(k[None]),
                              "v": jnp.asarray(v[None])})}
    tstate = {"blocks": [{"conv": torch.zeros(1)},
                         {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}]}
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = jbd.serve_batch_tiered(cfg, jstate, _args(**mode), B, P, P + G,
                                  trace_path=jpath)
    got = tbd.serve_batch_tiered(cfg, tstate, _args(**mode), B, P, P + G,
                                 trace_path=tpath)
    keys = [key for key in EXACT if key in want]
    assert {key: got.get(key) for key in keys} == {key: want[key]
                                                   for key in keys}
    assert set(got) - {"span_sweep_ms", "span_attention_ms",
                       "tiered_decode_s"} == set(want) - {
        "span_sweep_ms", "span_attention_ms", "tiered_decode_s"}
    assert got["tiered_equiv_ok"] and got["trace_totals_ok"]
    assert _events(tpath) == _events(jpath)
    with open(tpath) as f:
        assert json.load(f)["traceEvents"]


def test_find_dense_kv_and_unported_options():
    """``find_dense_kv``; and ``--shards`` must divide the cold pool. (The
    name is kept so the test's id stays: ``--shards > 1`` and ``--chaos``
    used to raise here and are now held against the reference in
    ``tests/test_torch_sharded.py``.)"""
    kc = torch.zeros(1, 5, 2, 4)
    state = {"blocks": [{"conv": kc, "h": kc}, {"k": kc, "v": kc + 1}]}
    k, v = tbd.find_dense_kv(state)
    assert k is kc and float(v.max()) == 1.0
    assert tbd.find_dense_kv({"blocks": [{"conv": kc}]}) == (None, None)
    cfg = jcfg.get_smoke_config("jamba_v01_52b")
    kv = torch.zeros(B, P + G, cfg.n_kv_heads, cfg.head_dim)
    state = {"blocks": [{"k": kv, "v": kv}]}
    n_pages = B * -(-(P + G) // 4)                          # 10 pages
    with pytest.raises(SystemExit, match=f"must divide the {n_pages}-page"):
        tbd.serve_batch_tiered(cfg, state, _args(shards=4), B, P, P + G)


def test_cli_batch_on_cpu_exits_zero_and_needs_cpu_asked(monkeypatch,
                                                         tmp_path):
    """``--arrival batch`` (the default) on the jamba smoke model with the
    paged replay and a trace exits 0 with ``--device cpu``; without it,
    on a host without a GPU, it fails naming ``device='cpu'``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    argv = ["--arch", "jamba_v01_52b", "--smoke", "--batch", "2",
            "--prompt-len", "16", "--gen", "3", "--page-size", "4",
            "--chunk", "2", "--ring-size", "4", "--paged",
            "--async-datapath", "--attn-kernel", "fused-async"]
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arrival", "batch", "--device", "cpu", *argv,
                          "--trace", str(tmp_path / "t.json")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "'tiered_equiv_ok': True" in res.stdout
    assert "'trace_totals_ok': True" in res.stdout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(argv)
