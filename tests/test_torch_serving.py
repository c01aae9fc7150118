"""Port: the continuous-batching engine against the JAX engine.

One test-side NumPy executor (duck-typed, as the reference engine allows)
drives both engines at the same small configuration; the comparison is on
integers only — admissions and request phases, TTFT steps, page
allocations and recycles, the pinned counter totals, the event log and the
per-step tiered/flat pin. (The two frameworks draw the per-step query from
different generators, so float outputs are not compared here.)
"""

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
from repro_torch.serving import (PINNED_COUNTERS, ServeConfig,  # noqa: E402
                                 ServingEngine, SyntheticExecutor)

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
    ex = SyntheticExecutor(2, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        ServingEngine(ServeConfig(shards=2), ex, device="cpu")
    with pytest.raises(NotImplementedError):
        ServingEngine(ServeConfig(migration=object()), ex, device="cpu")


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
