"""Port: the sharded cold pool's consume scan and the chaos copy against the
reference.

* ``place_perm`` / ``place_cold`` and the topology checks (a mesh whose
  ``"fabric"`` dim is not the shard count raises the reference's error);
* ``repro_torch.fabric.chaos`` against ``repro.fabric.chaos``: the spec's
  JSON round trip, ``compile_chaos``'s tables, the Q8 estimator and the
  re-home rule;
* ``sharded_multi_stream_consume`` across G in {1, 2, 4} shards x both
  placements x link budgets {None, 1, 2} on the clean fabric (and, in
  ``test_torch_sharded_chaos.py``, under a chaos spec of all four axes:
  slowdown, degradation, node loss, grants; adaptive deadlines): the same
  checksums, ``info`` columns (per-NIC demand, link totals; the final
  ``est_q`` under chaos), events and state (hot bytes included) as the
  reference's flat plane.

Payloads hold integers (exact in float32), so the checksums compare
exactly.
"""

import types
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.fabric import chaos as jc  # noqa: E402
from repro.obs.trace import decode_stream_events as j_events  # noqa: E402
from repro.paging import prefetch_serving as jps  # noqa: E402
from repro.paging import sharded_pool as jsp  # noqa: E402
from repro_torch.fabric import chaos as tc  # noqa: E402
from repro_torch.obs.trace import decode_stream_events as t_events  # noqa: E402
from repro_torch.paging import prefetch_serving as tps  # noqa: E402
from repro_torch.paging import sharded_pool as tsp  # noqa: E402

S, N_PAGES, N_SLOTS, T = 4, 48, 12, 28


def _spec(G: int) -> dict:
    """Four fault axes on ``G`` shards (node loss needs two)."""
    return dict(slowdown=((0, 3, 4, 18), (1 % G, 2, 8, 26)),
                degradation=((G - 1, 1, 6, 16),),
                node_loss=(G - 1, 11) if G > 1 else None,
                grants=((0, 3, 4, 22), (2, 2, 10, 20)),
                adaptive_deadline=True)


def _same(j, t, where):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape, where
    assert j.tobytes() == t.tobytes(), where


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("placement", ["block", "interleave"])
def test_placement_and_topology(G, placement):
    jf = jsp.ShardedPoolCfg(n_shards=G, placement=placement)
    tf = tsp.ShardedPoolCfg(n_shards=G, placement=placement)
    np.testing.assert_array_equal(jsp.place_perm(N_PAGES, jf),
                                  tsp.place_perm(N_PAGES, tf))
    cold = {"k": np.arange(N_PAGES * 3, dtype=np.float32).reshape(N_PAGES, 3),
            "v": -np.arange(N_PAGES, dtype=np.float32)}
    want = jsp.place_cold({k: jnp.asarray(v) for k, v in cold.items()},
                          N_PAGES, jf)
    got = tsp.place_cold({k: torch.from_numpy(v) for k, v in cold.items()},
                         N_PAGES, tf)
    for k in cold:
        _same(want[k], got[k], k)
    with pytest.raises(ValueError, match="not divisible"):
        tsp.check_fabric_topology(N_PAGES + 1, tf)
    mesh = types.SimpleNamespace(mesh_dim_names=("fabric",), shape=(G,))
    tsp.check_fabric_topology(N_PAGES, tf, mesh=mesh)
    for bad in (types.SimpleNamespace(mesh_dim_names=("fabric",),
                                      shape=(2 * G,)),
                types.SimpleNamespace(mesh_dim_names=("data",), shape=(G,))):
        with pytest.raises(ValueError, match="mesh fabric axis"):
            tsp.check_fabric_topology(N_PAGES, tf, mesh=bad)
    geom = tps.PrefetchedStream(n_pages=N_PAGES, n_slots=N_SLOTS,
                                page_elems=3, ring_size=4)
    sched = torch.zeros((S, 2), dtype=torch.int32)
    # the §12 lifecycle runs (tests/test_torch_migration.py holds it
    # against the reference); a disabled config is the two-tier scan
    from repro_torch.paging.lifecycle import MigrationCfg
    pool = torch.arange(N_PAGES * 3, dtype=torch.float32).reshape(N_PAGES, 3)
    st, _, info = tsp.sharded_multi_stream_consume(
        pool, sched, geom, tf, migration=MigrationCfg())
    assert info["mig_on_shard"].shape == (2, G) and "tier" in st
    off = tsp.sharded_multi_stream_consume(pool, sched, geom, tf)
    dis = tsp.sharded_multi_stream_consume(
        pool, sched, geom, tf, migration=MigrationCfg(enabled=False))
    assert set(off[2]) == set(dis[2]) and "tier" not in dis[0]
    assert all(torch.equal(off[2][k], dis[2][k]) for k in off[2])
    with pytest.raises(ValueError, match="ring"):
        tsp.sharded_multi_stream_consume(
            torch.zeros(N_PAGES, 3), sched,
            tps.PrefetchedStream(N_PAGES, N_SLOTS, 3, ring_size=0), tf)


def test_chaos_copy_matches_the_reference():
    for G in (1, 2, 4):
        jspec, tspec = jc.ChaosSpec(**_spec(G)), tc.ChaosSpec(**_spec(G))
        assert tspec.to_json() == jspec.to_json()
        assert tc.ChaosSpec.from_json(jspec.to_json()) == tspec
        assert tspec.any_faults == jspec.any_faults
        for placement in ("block", "interleave"):
            for budget in (None, 2):
                kw = dict(n_steps=T, n_streams=S, n_shards=G,
                          n_pages=N_PAGES, placement=placement,
                          base_budget=budget)
                want, got = jc.compile_chaos(jspec, **kw), \
                    tc.compile_chaos(tspec, **kw)
                assert set(want) == set(got)
                for k in want:
                    if k == "t_fail":
                        assert want[k] == got[k]
                    else:
                        np.testing.assert_array_equal(want[k], got[k])
                        assert want[k].dtype == got[k].dtype
        np.testing.assert_array_equal(jc.est_init(S, G, 1, 3),
                                      tc.est_init(S, G, 1, 3))
        for p in range(12):
            for dead in range(G):
                if G > 1:
                    assert (tc.rehome_shard(p, p % G, dead, G)
                            == jc.rehome_shard(p, p % G, dead, G))
    rng = np.random.default_rng(0)
    est = rng.integers(0, 2000, (S, 4)).astype(np.int32)
    obs = rng.integers(0, 40, (S, 4)).astype(np.int32)
    cnt = rng.integers(1, 6, (S, 4)).astype(np.int32)
    want = np.asarray(jc.est_step(jnp.asarray(est), jnp.asarray(obs),
                                  jnp.asarray(cnt)))
    got = tc.est_step(torch.from_numpy(est), torch.from_numpy(obs),
                      torch.from_numpy(cnt))
    _same(want, got, "est_step")
    assert tc.est_step(700, 9, 3) == jc.est_step(700, 9, 3)
    assert tc.est_delay(300) == jc.est_delay(300) and tc.est_delay(0) == 1
    assert tc.EST_ONE == jc.EST_ONE and tc.INF == jc.INF
    with pytest.raises(ValueError, match="node_loss"):
        tc.compile_chaos(tc.ChaosSpec(node_loss=(0, 3)), n_steps=4,
                         n_streams=1, n_shards=1, n_pages=8,
                         placement="block", base_budget=None)


#: G x placement x budget: one placement at G = 1, where every page is
#: home and the two placements are the same schedule
CASES = [pytest.param(G, placement, budget,
                      id=f"G{G}-{placement}-budget{budget}")
         for G in (1, 2, 4)
         for placement in (("interleave",) if G == 1
                           else ("block", "interleave"))
         for budget in (None, 1, 2)]


@pytest.mark.parametrize("G,placement,budget", CASES)
def test_sharded_consume_matches(G, placement, budget):
    """The clean fabric (``test_torch_sharded_chaos.py`` runs the same
    cases under the chaos spec, in a file of its own so that two workers
    share the reference's compiles)."""
    check_consume(G, placement, budget, chaos=False)


def check_consume(G, placement, budget, chaos):
    """The port's consume against the reference's flat plane."""
    rng = np.random.default_rng(G * 10 + (budget or 0))
    cold = {k: rng.integers(-99, 99, (N_PAGES, 2, 3)).astype(np.float32)
            for k in ("k", "v")}
    t = np.arange(T)
    sched = np.stack([(t * (s + 1) + 5 * s) % N_PAGES
                      for s in range(S)]).astype(np.int32)
    kw = dict(n_pages=N_PAGES, n_slots=N_SLOTS, page_elems=6, pw_max=4,
              ring_size=4)
    fkw = dict(n_shards=G, placement=placement, link_budget=budget,
               near_delay=1, far_delay=2)
    jst, jsums, jinfo = jsp.sharded_multi_stream_consume(
        {k: jnp.asarray(v) for k, v in cold.items()}, jnp.asarray(sched),
        jps.PrefetchedStream(**kw), jsp.ShardedPoolCfg(**fkw),
        chaos=jc.ChaosSpec(**_spec(G)) if chaos else None)
    tst, tsums, tinfo = tsp.sharded_multi_stream_consume(
        {k: torch.from_numpy(v) for k, v in cold.items()},
        torch.from_numpy(sched), tps.PrefetchedStream(**kw),
        tsp.ShardedPoolCfg(**fkw),
        chaos=tc.ChaosSpec(**_spec(G)) if chaos else None)
    assert set(jinfo) == set(tinfo) and ("est_q" in tinfo) == chaos
    _same(jsums, tsums, "sums")
    for k in jinfo:
        _same(jinfo[k], tinfo[k], k)
    for group in ("leap", "pool_meta", "ring", "hot"):
        for k in jst[group]:
            _same(jst[group][k], tst[group][k], f"{group}.{k}")
    stats = [tps.stream_stats_at(tst, s) for s in range(S)]
    assert stats == [jps.stream_stats_at(jst, s) for s in range(S)]
    tnp = {k: v.numpy() for k, v in tinfo.items()}
    topo = dict(n_pages=N_PAGES, n_shards=G, placement=placement,
                final_stats=stats)
    assert ([astuple(e) for e in j_events(sched, jinfo, **topo)]
            == [astuple(e) for e in t_events(sched, tnp, **topo)])
    assert int(tnp["shard_demand_fetches"].sum()) == int(
        tnp["fetched"].sum())
