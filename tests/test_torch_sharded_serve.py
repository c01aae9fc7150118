"""Port: the serving paths over four home shards against the reference.

* ``tiered_sweep(fabric=G 4)``, sync and async: the same ``info`` columns
  (per-NIC demand included), events and state as the reference's sweep
  (``use_kernel=False``), attention from the hot tier within 2e-5 of the
  reference's and bitwise equal to the flat pool inside the port;
* the batch driver at ``--shards 4`` with the chaos sidecar: the same
  report (pin, counters, per-shard demand, the sidecar's numbers), event
  log and Chrome trace (link and per-NIC counter tracks) as the
  reference's;
* the continuous engine at ``shards=4``: the same integers, events and
  link / per-NIC demand history;
* the port's CLI with ``--shards`` / ``--placement`` / ``--far-delay`` /
  ``--chaos`` on the CPU.

The reference builds a device mesh when ``shards > 1``; these tests hold
the port against its flat plane instead (``make_fabric_mesh`` patched to
return ``None`` inside each test), which the reference pins bitwise equal
to the mesh plane (``tests/test_sharded_pool.py``).
"""

import functools
import json
import types
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.mesh as jmesh  # noqa: E402
import repro.serving.batch_driver as jbd  # noqa: E402
from repro import configs as jcfg  # noqa: E402
from repro.obs.trace import decode_sweep_events as j_events  # noqa: E402
from repro.paging import sharded_pool as jsp  # noqa: E402
from repro.paging import tiered_kv as jt  # noqa: E402
from repro.serving.engine import ServeConfig as JCfg  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.convert import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.obs.trace import decode_sweep_events as t_events  # noqa: E402
from repro_torch.paging import sharded_pool as tsp  # noqa: E402
from repro_torch.paging import tiered_kv as tt  # noqa: E402
from repro_torch.paging.kv_cache import paged_decode_attention  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving import batch_driver as tbd  # noqa: E402

CPU = "cpu"
B, NPPS, PS, HKV, HQ, DH = 4, 8, 4, 2, 4, 8
N_PAGES = B * NPPS
#: four fault axes for four shards and four streams over the sidecar's
#: 48 steps
SPEC = {"slowdown": [[0, 3, 8, 30], [1, 2, 16, 40]],
        "degradation": [[2, 1, 12, 32]], "node_loss": [3, 24],
        "grants": [[0, 3, 8, 36]], "adaptive_deadline": True}


@pytest.fixture
def no_mesh(monkeypatch):
    """The reference's drivers on their flat plane."""
    monkeypatch.setattr(jmesh, "make_fabric_mesh", lambda n: None)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    cold = {k: rng.standard_normal((N_PAGES, PS, HKV, DH)).astype(np.float32)
            for k in ("k", "v")}
    base = np.arange(B)[:, None] * NPPS
    rows = (base + (np.arange(NPPS)[None] * 3) % NPPS).astype(np.int32)
    rows[1, 5:] = -1                               # a ragged row
    q = rng.standard_normal((B, 1, HQ, DH)).astype(np.float32)
    lengths = np.array([29, 17, 32, 5], np.int32)
    return cold, rows, q, lengths


@pytest.mark.parametrize("async_dp,placement,budget", [
    (False, "block", None), (True, "interleave", 1)])
def test_tiered_sweep_on_four_shards_matches(async_dp, placement, budget):
    cold, rows, q, lengths = _inputs()
    kw = dict(chunk=2, pw_max=4, ring_size=8)
    n_slots = tt.tiered_min_slots(NPPS, tt.TieredKV(N_PAGES, 1, PS, HKV, DH,
                                                    **kw))
    jg = jt.TieredKV(N_PAGES, n_slots, PS, HKV, DH, use_kernel=False, **kw)
    tg = tt.TieredKV(N_PAGES, n_slots, PS, HKV, DH, **kw)
    fkw = dict(n_shards=4, placement=placement, link_budget=budget,
               near_delay=1, far_delay=3)
    jf, tf = jsp.ShardedPoolCfg(**fkw), tsp.ShardedPoolCfg(**fkw)
    jst = jt.tiered_init(jg, B, jnp.float32)
    tst = tt.tiered_init(tg, B, torch.float32, device=CPU)
    jcold = {k: jnp.asarray(v) for k, v in cold.items()}
    tcold = tree_from_numpy(cold, CPU)
    inv = rows[:, 2:3].copy()
    for sweep in range(2):
        jst, jinfo = jt.tiered_sweep(jst, jcold, jnp.asarray(rows), jg,
                                     async_datapath=async_dp, fabric=jf)
        tst, tinfo = tt.tiered_sweep(tst, tcold, torch.from_numpy(rows), tg,
                                     async_datapath=async_dp, fabric=tf)
        tnp = {k: v.numpy() for k, v in tinfo.items()}
        assert set(jinfo) == set(tnp)
        for k in jinfo:
            np.testing.assert_array_equal(np.asarray(jinfo[k]), tnp[k],
                                          err_msg=f"sweep {sweep} {k}")
        assert tnp["shard_demand_fetches"].shape[1] == 4
        assert ([astuple(e) for e in j_events(jinfo, step_offset=3)]
                == [astuple(e) for e in t_events(tnp, step_offset=3)])
        jn, tn = jax_tree_np(jst), tree_to_numpy(tst)
        for group in ("leap", "pool_meta", "ring", "hot"):
            for k in jn[group]:
                np.testing.assert_array_equal(jn[group][k], tn[group][k],
                                              err_msg=f"{group}.{k}")
        jst = jt.tiered_invalidate(jst, jnp.asarray(inv))
        tst = tt.tiered_invalidate(tst, torch.from_numpy(inv))
    jst, jout, _, jok = jt.tiered_decode_step(
        jst, jcold, jnp.asarray(q), jnp.asarray(rows), jnp.asarray(lengths),
        jg, async_datapath=async_dp, fabric=jf, attn_kernel="fused")
    tq, trows, tlen = (torch.from_numpy(a) for a in (q, rows, lengths))
    tst, tout, _, tok = tt.tiered_decode_step(
        tst, tcold, tq, trows, tlen, tg, async_datapath=async_dp, fabric=tf,
        attn_kernel="fused")
    assert bool(jok) and bool(tok)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=2e-5)
    flat = paged_decode_attention(tq, {k: v[None] for k, v in tcold.items()},
                                  0, trows, tlen, use_kernel=True)
    assert torch.equal(tout, flat)


def jax_tree_np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _args(**kw):
    base = dict(page_size=4, streams=1, chunk=2, ring_size=4, shards=4,
                placement="interleave", link_budget=2, far_delay=2,
                attn_kernel="fused", gen=4, async_datapath=True, chaos=None)
    return types.SimpleNamespace(**(base | kw))


def test_batch_driver_on_four_shards_with_chaos_matches(monkeypatch, no_mesh,
                                                        tmp_path):
    cfg = jcfg.get_smoke_config("jamba_v01_52b")
    nb, P, G = 4, 16, 4                       # 4 x 5 pages: 20, split 4 ways
    rng = np.random.default_rng(0)
    k, v = (rng.standard_normal((nb, P + G, cfg.n_kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2))
    monkeypatch.setattr(jbd, "TieredKV",
                        functools.partial(jbd.TieredKV, use_kernel=False))
    spec = tmp_path / "chaos.json"
    spec.write_text(json.dumps(SPEC))
    args = _args(chaos=str(spec))
    jstate = {"blocks": ({"k": jnp.asarray(k[None]),
                          "v": jnp.asarray(v[None])},)}
    tstate = {"blocks": [{"k": torch.from_numpy(k), "v": torch.from_numpy(v)}]}
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = jbd.serve_batch_tiered(cfg, jstate, args, nb, P, P + G,
                                  trace_path=jpath)
    got = tbd.serve_batch_tiered(cfg, tstate, args, nb, P, P + G,
                                 trace_path=tpath)
    timing = {"span_sweep_ms", "span_attention_ms", "tiered_decode_s",
              "trace_path"}
    assert set(got) == set(want)
    assert {k: got[k] for k in set(got) - timing} == \
        {k: want[k] for k in set(want) - timing}
    assert got["tiered_equiv_ok"] and got["trace_totals_ok"]
    assert got["paged_shards"] == 4 and got["chaos_shards"] == 4
    assert sum(got["paged_shard_demand"]) > 0
    with open(jpath + ".jsonl") as f, open(tpath + ".jsonl") as g:
        assert f.read() == g.read()
    with open(jpath) as f, open(tpath) as g:
        jt_, tt_ = json.load(f), json.load(g)
    assert jt_ == tt_
    assert any(e.get("name") == "shard_demand_fetches"
               for e in tt_["traceEvents"])


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


def test_engine_on_four_shards_matches(no_mesh):
    kw = dict(requests=5, slots=3, prompt_len=8, gen=4, page_size=4,
              prefill_chunk=4, arrival="bursty", burst_len=2, seed=3,
              trace=True, async_datapath=True, attn_kernel="fused",
              link_budget=1, shards=4, placement="block", far_delay=3)
    jeng = JEngine(JCfg(use_kernel=False, **kw), NumpyExecutor())
    jrep = jeng.run()
    teng = ServingEngine(ServeConfig(**kw), NumpyExecutor(), device=CPU)
    trep = teng.run()
    assert jeng.n_pages == teng.n_pages and teng.n_pages % 4 == 0
    assert trep["tiered_equiv_ok"] and trep["trace_totals_ok"]
    assert trep["shards"] == 4 and trep["placement"] == "block"
    timing = {"wall_s", "token_latency"}
    assert {k: trep[k] for k in set(trep) - timing} == \
        {k: jrep[k] for k in set(jrep) - timing}
    assert [astuple(e) for e in jeng.events] == \
        [astuple(e) for e in teng.events]
    for hist in ("link_hist", "shard_hist"):
        np.testing.assert_array_equal(
            np.concatenate(getattr(jeng, hist)),
            np.concatenate(getattr(teng, hist)))


def test_cli_shards_and_chaos_on_cpu(tmp_path, capsys):
    spec = tmp_path / "chaos.json"
    spec.write_text(json.dumps(SPEC))
    res = tserve.main(
        ["--arch", "jamba_v01_52b", "--smoke", "--device", "cpu",
         "--batch", "4", "--prompt-len", "16", "--gen", "3",
         "--page-size", "4", "--chunk", "2", "--ring-size", "4", "--paged",
         "--async-datapath", "--attn-kernel", "fused-async", "--shards", "4",
         "--placement", "block", "--far-delay", "3", "--link-budget", "2",
         "--chaos", str(spec), "--trace", str(tmp_path / "t.json")])
    assert res["tiered_equiv_ok"] and res["trace_totals_ok"]
    assert res["paged_placement"] == "block" and res["chaos_steps"] == 48
    assert res["chaos_adaptive_deadline"] is True
    res = tserve.main(
        ["--synthetic", "--paged", "--arrival", "bursty", "--device", "cpu",
         "--requests", "4", "--slots", "2", "--prompt-len", "8", "--gen",
         "3", "--prefill-chunk", "4", "--shards", "2", "--far-delay", "3",
         "--trace", str(tmp_path / "e.json")])
    assert res["tiered_equiv_ok"] and res["shards"] == 2
    capsys.readouterr()
