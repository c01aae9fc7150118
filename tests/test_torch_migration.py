"""Port: the consume scan with the §12 lifecycle against the reference.

``sharded_multi_stream_consume(migration=...)`` on the flat plane, port
against reference, on the schedules of ``tests/test_migration.py`` (two
strided walks that spend most steps off their home shard): the same
checksums, ``info`` columns (``migrated`` / ``promoted`` / ``demoted`` /
``mig_on_shard`` / ``pf_on_shard`` among them), state (leap, pool, ring,
hot bytes and the ``tier`` tables) and decoded events, exactly, for

* four shards x {block, interleave} x link budget {None, 2} x {migration
  alone, migration with the compressed tier}, and two shards;
* the reference's hysteresis walk (two streams pulling the same pages
  toward different shards, 12 steps apart) at cooldown 4 and 16;
* the off-flag reduction: ``migration=None``, ``MigrationCfg(enabled=
  False)`` and the reference's two-tier scan all bitwise equal.

``test_torch_migration_chaos.py`` holds the node-loss case. Payloads are
integers, exact in float32, so the checksums compare exactly.
"""

from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs.trace import decode_stream_events as j_events  # noqa: E402
from repro.paging import lifecycle as jlc  # noqa: E402
from repro.paging import prefetch_serving as jps  # noqa: E402
from repro.paging import sharded_pool as jsp  # noqa: E402
from repro_torch.obs.trace import decode_stream_events as t_events  # noqa: E402
from repro_torch.paging import lifecycle as tlc  # noqa: E402
from repro_torch.paging import prefetch_serving as tps  # noqa: E402
from repro_torch.paging import sharded_pool as tsp  # noqa: E402

N_PAGES, T = 64, 48
GEOM = dict(n_pages=N_PAGES, n_slots=N_PAGES, page_elems=4, ring_size=8,
            pw_max=4)
#: the reference test's two configurations
MIG = dict(mig_per_stream=2, lead=1, cooldown=8)
MIG_COMP = dict(MIG, compressed=True, far_capacity=N_PAGES // 2,
                demote_per_step=2, decompress_delay=2)


def _scheds() -> np.ndarray:
    """Two strided walks that spend most steps off their home shard."""
    t = np.arange(T)
    return np.stack([(16 + 2 * t) % N_PAGES,
                     (40 + 3 * t) % N_PAGES]).astype(np.int32)


def _same(j, t, where):
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape, where
    assert j.tobytes() == t.tobytes(), where


def run_both(sched, fabric: dict, mig: dict | None, chaos=None):
    """The reference's and the port's consume on the same inputs; returns
    ``(reference, port)`` results."""
    pool = np.arange(N_PAGES * 4, dtype=np.float32).reshape(N_PAGES, 4)
    jchaos = tchaos = None
    if chaos is not None:
        from repro.fabric import chaos as jc
        from repro_torch.fabric import chaos as tc
        jchaos, tchaos = jc.ChaosSpec(**chaos), tc.ChaosSpec(**chaos)
    want = jsp.sharded_multi_stream_consume(
        jnp.asarray(pool), jnp.asarray(sched), jps.PrefetchedStream(**GEOM),
        jsp.ShardedPoolCfg(**fabric), chaos=jchaos,
        migration=None if mig is None else jlc.MigrationCfg(**mig))
    got = tsp.sharded_multi_stream_consume(
        torch.from_numpy(pool), torch.from_numpy(sched),
        tps.PrefetchedStream(**GEOM), tsp.ShardedPoolCfg(**fabric),
        chaos=tchaos,
        migration=None if mig is None else tlc.MigrationCfg(**mig))
    return want, got


def check_same(want, got, sched, fabric):
    """Every integer, checksum, table and event of the two runs."""
    (jst, jsums, jinfo), (tst, tsums, tinfo) = want, got
    S = sched.shape[0]
    assert set(jinfo) == set(tinfo)
    _same(jsums, tsums, "sums")
    for k in jinfo:
        _same(jinfo[k], tinfo[k], k)
    assert set(jst) == set(tst)
    for group in jst:
        if not isinstance(jst[group], dict):           # the hot payload
            _same(jst[group], tst[group], group)
            continue
        assert set(jst[group]) == set(tst[group]), group
        for k in jst[group]:
            _same(jst[group][k], tst[group][k], f"{group}.{k}")
    stats = [tps.stream_stats_at(tst, s) for s in range(S)]
    assert stats == [jps.stream_stats_at(jst, s) for s in range(S)]
    topo = dict(n_pages=N_PAGES, n_shards=fabric["n_shards"],
                placement=fabric["placement"], final_stats=stats)
    tnp = {k: v.numpy() for k, v in tinfo.items()}
    jev = [astuple(e) for e in j_events(sched, jinfo, **topo)]
    assert jev == [astuple(e) for e in t_events(sched, tnp, **topo)]
    return tnp


CASES = [pytest.param(G, placement, budget, name,
                      id=f"G{G}-{placement}-budget{budget}-{name}")
         for G, placements in ((4, ("block", "interleave")),
                               (2, ("interleave",)))
         for placement in placements
         for budget in ((None, 2) if G == 4 else (2,))
         for name in (("mig", "mig_comp") if G == 4 else ("mig_comp",))]


@pytest.mark.parametrize("G,placement,budget,name", CASES)
def test_consume_with_migration_matches(G, placement, budget, name):
    sched = _scheds()
    fabric = dict(n_shards=G, placement=placement, link_budget=budget,
                  near_delay=1, far_delay=3)
    mig = MIG_COMP if name == "mig_comp" else MIG
    want, got = run_both(sched, fabric, mig)
    tnp = check_same(want, got, sched, fabric)
    # the data plane is untouched: the served bytes are the schedule's
    pool = np.arange(N_PAGES * 4, dtype=np.float32).reshape(N_PAGES, 4)
    np.testing.assert_array_equal(got[1].numpy(), pool[sched].sum(-1))
    # the pins above are not vacuous
    assert int(tnp["migrated"].sum()) > 0
    if name == "mig_comp":
        assert int(tnp["demoted"].sum()) > 0
        assert int(tnp["promoted"].sum()) > 0
    tier = got[0]["tier"]
    assert int(tier["n_migrations"]) == int(tnp["migrated"].sum())
    assert int(tier["n_demotions"]) == int(tnp["demoted"].sum())


@pytest.mark.parametrize("cooldown", [4, 16])
def test_hysteresis_walk_matches(cooldown):
    """The reference's hysteresis walk: with a cooldown beyond the lag each
    page moves at most once; below it some move twice."""
    lag = 12
    t = np.arange(T)
    sched = np.stack([(8 + t) % N_PAGES,
                      (8 + t - lag) % N_PAGES]).astype(np.int32)
    fabric = dict(n_shards=4, placement="block", link_budget=6,
                  near_delay=1, far_delay=3)
    want, got = run_both(sched, fabric, dict(mig_per_stream=2, lead=1,
                                             cooldown=cooldown))
    tnp = check_same(want, got, sched, fabric)
    migs = int(tnp["migrated"].sum())
    stamped = int((got[0]["tier"]["last_mig"] > -(1 << 20)).sum())
    assert migs > 0 and migs <= stamped * (1 + (T - 1) // cooldown)
    assert (migs == stamped) if cooldown > lag else (migs > stamped)


def test_off_flag_reduction_is_bitwise():
    """``None``, ``enabled=False`` and the reference's two-tier scan: the
    same results, and no lifecycle key."""
    sched = _scheds()
    fabric = dict(n_shards=4, placement="interleave", link_budget=2,
                  near_delay=1, far_delay=3)
    want, off = run_both(sched, fabric, None)
    check_same(want, off, sched, fabric)
    dis = tsp.sharded_multi_stream_consume(
        torch.arange(N_PAGES * 4, dtype=torch.float32).reshape(N_PAGES, 4),
        torch.from_numpy(sched), tps.PrefetchedStream(**GEOM),
        tsp.ShardedPoolCfg(**fabric),
        migration=tlc.MigrationCfg(enabled=False))
    assert "tier" not in off[0] and "tier" not in dis[0]
    assert set(off[2]) == set(dis[2]) and "migrated" not in dis[2]
    assert torch.equal(off[1], dis[1])
    for k in off[2]:
        assert torch.equal(off[2][k], dis[2][k]), k
    assert torch.equal(off[0]["hot"], dis[0]["hot"])
    for group in ("leap", "pool_meta", "ring"):
        for k in off[0][group]:
            assert torch.equal(off[0][group][k], dis[0][group][k]), k
