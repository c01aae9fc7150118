"""Port: the serving engine and the CLI with the §12 lifecycle against the
reference.

* The reference's ``_run_serving`` configuration
  (``tests/test_migration.py``: 5 requests on 2 slots, bursty, the
  compressed tier at 8 pages, 2 demotions a step, cooldown 8) through both
  engines on one shard, and on four (block placement, link budget 1,
  prompts of 24 and 6 generated in a 32-page pool, so that the trend's
  targets lie in the pool and migrations fire) with the reference on its
  flat plane: the same report (its ``residency``
  among the keys), event log (migrate / demote / promote included), link
  and per-NIC demand history, and sweep ``info`` integers step by step;
  the Chrome trace of the port's events equal to the reference writer's;
  the tiered/flat pin on every step; the demoted pages' cold bytes within
  the codec's ``scale / 2`` of the reference engine's (which round-trips
  under ``jax.jit(vmap)`` and so may round a scale one ulp apart).
* The off-flag reduction: ``migration=None`` and ``enabled=False`` give
  the same report, and the reference's.
* The CLI: ``--migration``, ``--compressed-tier`` and ``--mig-cooldown``
  with the reference's defaults and help, its ``--arrival batch`` error,
  and the same integers and residency as the reference CLI.

Both engines take one test-side NumPy executor, so the K/V bytes are the
same on both sides.
"""

import json
from dataclasses import astuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.mesh as jmesh  # noqa: E402
import repro.serving.engine as jengine  # noqa: E402
from repro.paging import lifecycle as jlc  # noqa: E402
from repro_torch.paging import lifecycle as tlc  # noqa: E402
from repro_torch.serving import engine as tengine  # noqa: E402
from test_torch_serving import CLI_KEYS, NumpyExecutor  # noqa: E402

#: ``tests/test_migration.py::_run_serving``
SERVE = dict(requests=5, slots=2, prompt_len=8, gen=4, page_size=4,
             prefill_chunk=4, arrival="bursty", burst_len=2,
             think_time=1000.0, idle_time=3000.0, seed=3, trace=True)
MIG = dict(compressed=True, far_capacity=8, demote_per_step=2,
           decompress_delay=2, cooldown=8)
TIMING = {"wall_s", "token_latency"}


def _spy(monkeypatch, module, log):
    """Record every sweep's ``info`` of ``module``'s engine as numpy."""
    real = module.tiered_sweep

    def sweep(*a, **kw):
        st, info = real(*a, **kw)
        log.append({k: np.asarray(v) for k, v in info.items()})
        return st, info

    monkeypatch.setattr(module, "tiered_sweep", sweep)


def run_both(monkeypatch, mig: dict | None, **extra):
    """The reference engine (flat plane, plain versions) and the port's on
    the same configuration; returns ``(jeng, jrep, jinfo, teng, trep,
    tinfo)``."""
    monkeypatch.setattr(jmesh, "make_fabric_mesh", lambda n: None)
    jinfo, tinfo = [], []
    _spy(monkeypatch, jengine, jinfo)
    _spy(monkeypatch, tengine, tinfo)
    kw = dict(SERVE, **extra)
    jeng = jengine.ServingEngine(jengine.ServeConfig(
        use_kernel=False, migration=None if mig is None
        else jlc.MigrationCfg(**mig), **kw), NumpyExecutor())
    jrep = jeng.run()
    teng = tengine.ServingEngine(tengine.ServeConfig(
        migration=None if mig is None else tlc.MigrationCfg(**mig), **kw),
        NumpyExecutor(), device="cpu")
    trep = teng.run()
    return jeng, jrep, jinfo, teng, trep, tinfo


def _kinds(events) -> dict:
    out: dict = {}
    for e in events:
        out[e.kind] = out.get(e.kind, 0) + max(e.count, 1)
    return out


@pytest.mark.parametrize("fabric", [
    pytest.param({}, id="one-shard"),
    pytest.param(dict(shards=4, placement="block", link_budget=1,
                      async_datapath=True, attn_kernel="fused",
                      prompt_len=24, gen=6, pool_pages=32),
                 id="four-shards")])
def test_engine_with_lifecycle_matches(monkeypatch, tmp_path, fabric):
    jeng, jrep, jinfo, teng, trep, tinfo = run_both(monkeypatch, MIG,
                                                    **fabric)
    assert trep["tiered_equiv_ok"] and trep["trace_totals_ok"]
    assert {k: trep[k] for k in set(trep) - TIMING} == \
        {k: jrep[k] for k in set(jrep) - TIMING}
    res = trep["residency"]
    assert res["demotions"] > 0 and res["compressed"] > 0
    assert res["promotions"] > 0
    assert res["uncompressed"] + res["compressed"] == res["n_pages"]
    if fabric:
        assert res["migrations"] > 0
    assert _kinds(teng.events) == _kinds(jeng.events)
    assert [astuple(e) for e in teng.events] == \
        [astuple(e) for e in jeng.events]
    assert len(tinfo) == len(jinfo) > 0
    for step, (j, t) in enumerate(zip(jinfo, tinfo)):
        assert set(j) == set(t)
        for k in j:
            np.testing.assert_array_equal(j[k], t[k],
                                          err_msg=f"sweep {step} {k}")
    for hist in ("link_hist", "shard_hist"):
        np.testing.assert_array_equal(
            np.concatenate(getattr(jeng, hist)),
            np.concatenate(getattr(teng, hist)))
    # the Chrome trace, lifecycle events included, equals the reference
    # writer's whole
    from repro.obs.export import to_chrome_trace
    from repro_torch.obs.export import write_chrome_trace
    counters = {"link_demand_fetches": np.concatenate(teng.link_hist),
                "shard_demand_fetches": np.concatenate(teng.shard_hist)}
    out = tmp_path / "t.json"
    write_chrome_trace(str(out), teng.events, counters,
                       request_phases=teng.phases)
    want = to_chrome_trace(teng.events, counters, request_phases=teng.phases)
    assert json.loads(out.read_text()) == json.loads(json.dumps(want))
    assert {"demote", "promote"} <= {e.kind for e in teng.events}
    # the cold bytes: the lossy trip leaves both engines within the codec's
    # bound of each other, page by page
    for k in ("k", "v"):
        want = np.asarray(jeng.pool[k][0])
        got = teng.pool[k][0].numpy()
        assert want.shape == got.shape
        half = np.abs(want).reshape(want.shape[0], -1).max(1) / 127 / 2
        err = np.abs(want - got).reshape(want.shape[0], -1).max(1)
        assert (err <= half * (1 + 1e-5) + 1e-30).all(), k


def test_off_flag_reduction(monkeypatch):
    """``None`` and ``enabled=False``: one report, the reference's."""
    _, jrep, _, teng, off, _ = run_both(monkeypatch, None)
    dis = tengine.ServingEngine(tengine.ServeConfig(
        migration=tlc.MigrationCfg(enabled=False), **SERVE),
        NumpyExecutor(), device="cpu")
    drep = dis.run()
    assert "residency" not in off and "residency" not in drep
    assert dis.lifecycle is None and teng.lifecycle is None
    assert {k: drep[k] for k in set(drep) - TIMING} == \
        {k: off[k] for k in set(off) - TIMING} == \
        {k: jrep[k] for k in set(jrep) - TIMING}
    assert [astuple(e) for e in dis.events] == \
        [astuple(e) for e in teng.events]


LIFECYCLE_FLAGS = ("--migration", "--compressed-tier", "--mig-cooldown")


def test_cli_flags_defaults_and_batch_error(capsys):
    from repro.launch.serve import build_parser as jparser
    from repro_torch.launch.serve import build_parser as tparser
    from repro_torch.launch.serve import main as tmain
    opts = lambda ap: {a.option_strings[0]: (a.dest, a.default, a.help)
                       for a in ap._actions
                       if a.option_strings and a.dest != "help"}
    want, got = opts(jparser()), opts(tparser())
    # the port's own two: the device and the depth cut
    assert set(got) - set(want) == {"--device", "--layers"}
    assert set(want) <= set(got) and len(want) == 31
    for flag in LIFECYCLE_FLAGS:
        assert got[flag] == want[flag], flag
    assert {f: got[f][:2] for f in want} == {f: want[f][:2] for f in want}
    for flag in (["--migration"], ["--compressed-tier", "8"]):
        with pytest.raises(SystemExit) as e:
            tmain(["--synthetic", "--device", "cpu", *flag])
        assert e.value.code == 2
        assert "need the continuous engine" in capsys.readouterr().err


def test_cli_lifecycle_matches_the_reference_cli():
    """(The sync data path: the reference's async Pallas kernels fail on
    the installed JAX, ROADMAP queue 3.)"""
    from repro.launch.serve import main as jmain
    from repro_torch.launch.serve import main as tmain
    args = ["--synthetic", "--paged", "--arrival", "bursty", "--batch", "2",
            "--requests", "4", "--prompt-len", "16", "--gen", "4",
            "--page-size", "4", "--prefill-chunk", "8",
            "--compressed-tier", "6", "--mig-cooldown", "4"]
    want = jmain(args)
    got = tmain(args + ["--device", "cpu"])
    keys = CLI_KEYS + ("residency",)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["residency"]["demotions"] > 0
