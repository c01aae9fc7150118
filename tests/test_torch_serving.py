"""Port: the continuous-batching engine against the JAX engine.

One test-side NumPy executor (duck-typed, as the reference engine allows)
drives both engines at the same small configuration; the comparison is on
integers only — admissions and request phases, TTFT steps, page
allocations and recycles, the pinned counter totals, the event log and the
per-step tiered/flat pin. (The two frameworks draw the per-step query from
different generators, so float outputs are not compared here.) With the
model executors (the reference's parameters converted, its prompt tokens
handed over) the emitted tokens are compared as well.
"""

import json
import os
import subprocess
import sys
from dataclasses import astuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.engine import PINNED_COUNTERS as J_PINNED  # noqa: E402
from repro.serving.engine import ServeConfig as JCfg  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.paging.tiered_kv import tiered_stats as j_stats  # noqa: E402
from repro_torch.paging.tiered_kv import tiered_stats as t_stats  # noqa: E402
from repro_torch.serving import (PINNED_COUNTERS, ModelExecutor,  # noqa: E402
                                 ServeConfig, ServingEngine,
                                 SyntheticExecutor)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class NumpyExecutor:
    """K/V from a numpy generator keyed by (seed, request, position)."""

    def __init__(self, n_kv_heads=2, head_dim=8, n_q_heads=4, seed=0):
        self.n_kv_heads, self.head_dim = n_kv_heads, head_dim
        self.n_q_heads, self.dtype, self.seed = n_q_heads, "float32", seed

    def begin(self, req):
        pass

    def end(self, req):
        pass

    def _kv(self, req, start, n):
        kv = np.stack([np.random.default_rng([self.seed, req.req_id, p])
                       .standard_normal((2, self.n_kv_heads, self.head_dim))
                       for p in range(start, start + n)]).astype(np.float32)
        return kv[:, 0], kv[:, 1]

    def prefill_chunk(self, req, n):
        k, v = self._kv(req, req.prefilled, n)
        done = req.prefilled + n >= req.prompt_len
        return k, v, (req.req_id % 251 if done else None)

    def decode(self, req):
        k, v = self._kv(req, req.prefilled + req.decoded - 1, 1)
        return k[0], v[0], (req.req_id + req.decoded) % 251


def _totals(eng, stats):
    out = []
    for s in range(eng.cfg.slots):
        cur = stats(eng.tstate, s)
        out.append({k: eng.counter_base[s][k] + int(cur[k])
                    for k in PINNED_COUNTERS})
    return out


CFG = dict(requests=5, slots=2, prompt_len=8, gen=4, page_size=4,
           prefill_chunk=4, arrival="bursty", burst_len=2, think_time=1000.0,
           idle_time=3000.0, seed=3, trace=True, length_jitter=0.4)


@pytest.mark.parametrize("async_dp,mode,budget", [(False, "fused", None),
                                                  (True, "ref", 1),
                                                  (True, "kernel", None)])
def test_engine_integers_match_jax(async_dp, mode, budget):
    assert PINNED_COUNTERS == J_PINNED
    kw = dict(CFG, async_datapath=async_dp, attn_kernel=mode,
              link_budget=budget)
    jeng = JEngine(JCfg(use_kernel=False, **kw), NumpyExecutor())
    jrep = jeng.run()
    teng = ServingEngine(ServeConfig(**kw), NumpyExecutor(), device="cpu")
    trep = teng.run()
    _assert_engines_agree(jeng, jrep, teng, trep)


def _assert_engines_agree(jeng, jrep, teng, trep):
    assert jrep["tiered_equiv_ok"] and trep["tiered_equiv_ok"]
    for key in ("steps", "requests_finished", "tokens_decoded",
                "pages_allocated", "pages_recycled", "alloc_in_use_end",
                "alloc_occupancy_peak", "prefetch_hits_total",
                "deferred_total", "trace_totals_ok", "trace_events",
                "ttft_steps", "mean_ttft_steps"):
        assert jrep[key] == trep[key], key
    assert [astuple(p) for p in jeng.phases] == \
        [astuple(p) for p in teng.phases]
    assert [astuple(e) for e in jeng.events] == \
        [astuple(e) for e in teng.events]
    assert _totals(jeng, j_stats) == _totals(teng, t_stats)
    assert jeng.reg.histogram("ttft_steps").samples == \
        teng.reg.histogram("ttft_steps").samples


class TokenLog:
    """Wraps an executor; logs each emitted token with the gap between
    its logit and the runner-up's."""

    def __init__(self, ex):
        self.ex, self.log = ex, []

    def __getattr__(self, name):
        return getattr(self.ex, name)

    def _note(self, req, out):
        if out[2] is not None:
            top2 = np.sort(np.asarray(self.ex.last_logits[req.req_id]))[-2:]
            self.log.append((req.req_id, out[2], float(top2[1] - top2[0])))
        return out

    def prefill_chunk(self, req, n):
        return self._note(req, self.ex.prefill_chunk(req, n))

    def decode(self, req):
        return self._note(req, self.ex.decode(req))


MODEL_CFG = dict(CFG, prompt_len=6, gen=3, requests=4, seed=3,
                 async_datapath=True)


@pytest.fixture(scope="module")
def jax_model_run():
    """The JAX engine with the reference ``ModelExecutor`` (smoke
    qwen2.5-3b, f32) under ``attn_kernel="fused"``: its async Pallas
    kernel does not run on this JAX, and the engine's integer outcomes do
    not depend on the attention mode. Executor seed 1: its nine emitted
    tokens lead their runner-up by 0.0195 or more (seed 0's by as little
    as 0.0006, a near tie)."""
    import jax
    from repro import configs as jcfg
    from repro.serving.executor import ModelExecutor as JExecutor
    jex = JExecutor(jcfg.get_smoke_config("qwen2_5_3b"), seed=1)
    jeng = JEngine(JCfg(use_kernel=False, attn_kernel="fused",
                        **MODEL_CFG), TokenLog(jex))
    prompts = {r.req_id: np.asarray(jex.prompt_tokens(r))
               for r in jeng.queue._pending}
    jrep = jeng.run()
    params = jax.tree.map(np.asarray, jex.params)
    return jeng, jrep, params, prompts


@pytest.mark.parametrize("mode", ["fused", "fused_async"])
def test_model_engine_matches_jax(jax_model_run, mode):
    """The port's engine with the port's ``ModelExecutor`` against the JAX
    engine: the integers exactly, and the same emitted tokens. Each
    compared token's top-2 logit gap must exceed the 5e-3 model
    tolerance, so a near tie fails here loudly instead of flaking."""
    from repro_torch import configs as tcfg
    from repro_torch.convert import model_params_from_jax
    jeng, jrep, params, prompts = jax_model_run
    cfg = tcfg.get_smoke_config("qwen2_5_3b")
    tex = ModelExecutor(cfg, device="cpu", prompts=prompts,
                        model=model_params_from_jax(params, cfg, "cpu"))
    teng = ServingEngine(ServeConfig(attn_kernel=mode, **MODEL_CFG),
                         TokenLog(tex), device="cpu")
    trep = teng.run()
    _assert_engines_agree(jeng, jrep, teng, trep)
    jlog, tlog = jeng.ex.log, teng.ex.log
    assert len(jlog) == trep["tokens_decoded"] > 0
    assert min(gap for _, _, gap in jlog) > 5e-3
    assert [(r, t) for r, t, _ in tlog] == [(r, t) for r, t, _ in jlog]


def test_synthetic_executor_bytes_depend_only_on_key():
    ex = SyntheticExecutor(2, 8, seed=5, n_q_heads=4, device="cpu")
    from repro_torch.serving.request import Request
    r = Request(req_id=3, prompt_len=10, gen=2)
    k_all, v_all, _ = ex.prefill_chunk(r, 10)
    r.prefilled = 4
    k_part, v_part, tok = ex.prefill_chunk(r, 6)
    assert tok == 3 % 251
    assert torch.equal(k_all[4:], k_part) and torch.equal(v_all[4:], v_part)
    assert not torch.equal(k_all, v_all)
    other = SyntheticExecutor(2, 8, seed=6, device="cpu")
    assert not torch.equal(other.prefill_chunk(
        Request(req_id=3, prompt_len=10, gen=2), 10)[0], k_all)
    assert abs(float(k_all.float().mean())) < 0.5
    assert 0.5 < float(k_all.float().std()) < 1.5


def test_engine_synthetic_bf16_gqa_drains_clean():
    ex = SyntheticExecutor(2, 16, dtype="bfloat16", n_q_heads=8,
                           device="cpu")
    eng = ServingEngine(ServeConfig(**dict(CFG, async_datapath=True,
                                           attn_kernel="fused")), ex,
                        device="cpu")
    rep = eng.run()
    assert rep["tiered_equiv_ok"] and rep["trace_totals_ok"]
    assert rep["requests_finished"] == 5 and rep["alloc_in_use_end"] == 0
    assert rep["pages_allocated"] == rep["pages_recycled"] > 0


def test_unported_engine_options_raise():
    """A mesh whose fabric axis is not the shard count raises the
    reference's error (``tests/test_torch_fabric_mesh.py`` runs the mesh
    plane); the §12 lifecycle builds its host mirror (a disabled config
    none, ``tests/test_torch_serving_lifecycle.py`` holds its runs against
    the reference); ``shards > 1`` without a mesh builds the sharded
    engine on the flat data plane, its pool rounded up to split
    over the shards (``tests/test_torch_sharded.py`` holds its runs
    against the reference)."""
    import types

    from repro_torch.paging.lifecycle import MigrationCfg
    ex = SyntheticExecutor(2, 8, device="cpu")
    mesh = types.SimpleNamespace(mesh_dim_names=("fabric",), shape=(4,))
    with pytest.raises(ValueError, match="mesh fabric axis 4 != n_shards 2"):
        ServingEngine(ServeConfig(shards=2), ex, device="cpu", mesh=mesh)
    assert ServingEngine(ServeConfig(shards=2), ex, device="cpu").mesh is None
    eng = ServingEngine(ServeConfig(shards=2, migration=MigrationCfg(
        compressed=True, far_capacity=4)), ex, device="cpu")
    assert eng.lifecycle.report()["per_shard"] == [eng.n_pages // 2] * 2
    assert ServingEngine(ServeConfig(migration=MigrationCfg(enabled=False)),
                         ex, device="cpu").lifecycle is None
    eng = ServingEngine(ServeConfig(shards=3), ex, device="cpu")
    assert eng.n_pages % 3 == 0 and eng.fabric.n_shards == 3


@pytest.mark.parametrize("extra", [[], ["--async-datapath",
                                        "--attn-kernel", "fused"]])
def test_cli_exits_zero_on_cpu(extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--synthetic",
           "--paged", "--device", "cpu", "--requests", "4", "--slots", "2",
           "--prompt-len", "8", "--gen", "3", "--prefill-chunk", "4",
           "--arrival", "bursty", *extra]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "'tiered_equiv_ok': True" in res.stdout


def test_model_cli_fused_async_writes_the_trace(tmp_path):
    """The model CLI (smoke qwen2.5-3b on the CPU) through fused-async
    with ``--trace``: exits 0, and the Chrome trace and JSONL siblings hold
    the run's events and request phases."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = tmp_path / "t.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
           "--device", "cpu", "--attn-kernel", "fused-async",
           "--async-datapath", "--paged", "--arrival", "bursty",
           "--requests", "3", "--slots", "2", "--prompt-len", "6", "--gen",
           "3", "--prefill-chunk", "4", "--trace", str(out)]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "'tiered_equiv_ok': True" in res.stdout
    trace = json.loads(out.read_text())
    kinds = {e.get("cat") for e in trace["traceEvents"]}
    assert {"admit", "prefill_chunk", "decode", "evict"} <= kinds
    events = out.with_name("t.json.jsonl").read_text().splitlines()
    phases = out.with_name("t.json.requests.jsonl").read_text().splitlines()
    assert events and all(json.loads(e)["kind"] for e in events)
    assert len(phases) == len([e for e in trace["traceEvents"]
                               if e.get("pid") == 2 and e["ph"] != "M"])


def test_chrome_trace_matches_the_reference_writer(tmp_path):
    """The port's Chrome trace of one engine run equals the reference
    writer's on the same events, link counters and request phases."""
    from repro.obs.export import to_chrome_trace
    from repro_torch.obs.export import write_chrome_trace
    eng = ServingEngine(ServeConfig(**CFG, async_datapath=True),
                        NumpyExecutor(), device="cpu")
    eng.run()
    out = tmp_path / "t.json"
    counters = {"link_demand_fetches": np.concatenate(eng.link_hist),
                "shard_demand_fetches": np.concatenate(eng.shard_hist)}
    write_chrome_trace(str(out), eng.events, counters,
                       request_phases=eng.phases)
    want = to_chrome_trace(eng.events, counters, request_phases=eng.phases)
    assert json.loads(out.read_text()) == json.loads(json.dumps(want))


CLI_ARGS = ["--synthetic", "--paged", "--arrival", "bursty", "--batch", "3",
            "--requests", "5", "--prompt-len", "32", "--gen", "4",
            "--page-size", "4", "--prefill-chunk", "8"]
#: every integer outcome of a continuous-engine run (and the admission mode)
CLI_KEYS = ("slots", "admission", "requests", "steps", "requests_finished",
            "tokens_decoded", "ttft_steps", "mean_ttft_steps",
            "pages_allocated", "pages_recycled", "alloc_in_use_end",
            "alloc_occupancy_peak", "prefetch_hits_total", "deferred_total",
            "tiered_equiv_ok")


@pytest.mark.parametrize("extra", [["--gang"],
                                   ["--pool-pages", "24",
                                    "--think-time", "2500"]])
def test_cli_engine_flags_match_the_reference_cli(extra):
    """``--gang``, ``--pool-pages`` and ``--think-time`` reach the engine
    as in the reference CLI, and ``--slots`` unset follows ``--batch``:
    with the same arguments the two CLIs give the same integers. (24 pool
    pages sit under the 27 that three slots of nine pages would get, so
    admission waits on memory. The think time of 2500 changes the
    reference's integers against its default of 1000, so a port that
    dropped the flag would fail.)"""
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main as tmain
    want = jmain(CLI_ARGS + extra)
    if "--think-time" in extra:
        i = extra.index("--think-time")
        default = jmain(CLI_ARGS + extra[:i] + extra[i + 2:])
        assert ({k: default[k] for k in CLI_KEYS}
                != {k: want[k] for k in CLI_KEYS})
    got = tmain(CLI_ARGS + extra + ["--device", "cpu"])
    assert {k: got[k] for k in CLI_KEYS} == {k: want[k] for k in CLI_KEYS}
    assert got["slots"] == 3
    assert got["admission"] == ("gang" if "--gang" in extra
                                else "continuous")


@pytest.mark.parametrize("slots,want", [([], 5), (["--slots", "2"], 2)])
def test_cli_slots_default_to_batch(slots, want):
    from repro_torch.launch.serve import build_parser
    from repro_torch.launch.serve import main as tmain
    args = ["--synthetic", "--paged", "--arrival", "bursty", "--batch", "5",
            "--requests", "3", "--prompt-len", "8", "--gen", "3",
            "--prefill-chunk", "4", "--device", "cpu", *slots]
    assert build_parser().parse_args(args).slots == (want if slots else None)
    assert tmain(args)["slots"] == want
