"""Port: the payload pool and the page-stream layer against the reference.

* ``pool_wait`` (one demand a stream) with landing grants, metadata-only
  and carrying a ``{"k", "v"}`` payload: the same state, ring, slots,
  served bytes and copy plan as the reference vmapped over the streams;
  ``link_grants`` the same grants.
* ``stream_consume`` / ``multi_stream_consume``, sync and async, ring 0 and
  4, a plain array and a pytree payload, with and without a shared link
  budget: the same checksums, ``info`` columns, ``decode_stream_events``,
  state (controller, pool, ring, hot bytes) and ``stream_stats``.
* inside the port: ``ring_size=0`` on the async path equals the sync path
  bit for bit.

Payloads hold integers (exact in float32), so every order of summation
gives the same checksum and the checksums compare exactly; the hot bytes
compare exactly whatever they hold.
"""

from dataclasses import astuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pool as jp  # noqa: E402
from repro.obs.trace import decode_stream_events as j_events  # noqa: E402
from repro.paging import prefetch_serving as jps  # noqa: E402
from repro_torch.core import pool as tp  # noqa: E402
from repro_torch.obs.trace import decode_stream_events as t_events  # noqa: E402
from repro_torch.paging import prefetch_serving as tps  # noqa: E402

CPU = "cpu"
S, N_PAGES, N_SLOTS, R, T = 3, 40, 12, 4, 24


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same_tree(j, t, where):
    if isinstance(j, dict):
        assert set(j) == set(t), where
        for k in j:
            _same_tree(j[k], t[k], f"{where}.{k}")
        return
    j = np.asarray(j)
    t = t.numpy()
    assert j.dtype == t.dtype and j.shape == t.shape, where
    assert j.tobytes() == t.tobytes(), where


def _payload(seed, tree):
    rng = np.random.default_rng(seed)
    make = lambda *sh: rng.integers(-99, 99, sh).astype(np.float32)
    return ({"k": make(N_PAGES, 2, 3), "v": make(N_PAGES, 2, 3)} if tree
            else make(N_PAGES, 6))


def _schedules(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    return np.stack([(3 * t) % N_PAGES,                    # a stride
                     (N_PAGES - 1 - 2 * t) % N_PAGES,      # backwards
                     rng.integers(0, N_PAGES, T)]).astype(np.int32)


@pytest.mark.parametrize("tree", [False, True])
def test_pool_wait_issue_and_grants_match(tree):
    """Issue / grant / wait rounds, ``pool_wait`` with a payload (or
    without), against the reference step for step."""
    rng = np.random.default_rng(40 + tree)
    pool = _payload(1, tree)
    jpool = jax.tree.map(jnp.asarray, pool)
    tpool = {k: _t(v) for k, v in pool.items()} if tree else _t(pool)
    hot_of = lambda z: (jax.tree.map(lambda c: z((S, N_SLOTS) + c.shape[1:]),
                                     pool))
    jhot = hot_of(jnp.zeros)
    thot = (torch.zeros((S, N_SLOTS, 6)) if not tree else
            {k: torch.zeros((S, N_SLOTS, 2, 3)) for k in pool})
    one = jp.pool_init(N_PAGES, N_SLOTS)
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape), one)
    jrg = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                       jp.ring_init(R))
    tst = tp.pool_init(N_PAGES, N_SLOTS, S, device=CPU)
    trg = tp.ring_init(R, S, device=CPU)
    jwait = jax.vmap(lambda st, rg, h, p, now, ok: jp.pool_wait(
        st, rg, h, jpool, p, now, land_ok=ok))
    jwait_meta = jax.vmap(lambda st, rg, p, now, ok: jp.pool_wait(
        st, rg, None, None, p, now, land_ok=ok))
    jissue = jax.vmap(lambda st, rg, p, v, now, d, sq: jp.pool_issue(
        st, rg, p, v, now, d, seq=sq))
    now = np.zeros((S,), np.int32)
    for step in range(16):
        cands = rng.integers(-1, N_PAGES, (S, 3)).astype(np.int32)
        val = rng.random((S, 3)) < 0.9
        delay = rng.integers(1, 3, (S, 3)).astype(np.int32)
        seq = (step * S * 3 + np.arange(S * 3)).reshape(S, 3).astype(np.int32)
        jst, jrg = jissue(jst, jrg, jnp.asarray(cands), jnp.asarray(val),
                          jnp.asarray(now), jnp.asarray(delay),
                          jnp.asarray(seq))
        tst, trg = tp.pool_issue(tst, trg, _t(cands), _t(val), _t(now),
                                 _t(delay), seq=_t(seq))
        now = now + 1
        cap = int(rng.integers(0, 4))
        jok = jp.link_grants({k: jrg[k] for k in ("page", "ready", "seq")},
                             jnp.asarray(now), jnp.int32(cap))
        tok = tp.link_grants(trg, _t(now), cap)
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
        page = rng.integers(-1, N_PAGES + 1, S).astype(np.int32)
        if step % 4 == 3:                 # the metadata-only mode too
            jst, jrg, _, jslot, _, jinfo = jwait_meta(
                jst, jrg, jnp.asarray(page), jnp.asarray(now), jok)
            tst, trg, hot_none, tslot, data_none, tinfo = tp.pool_wait(
                tst, trg, None, None, _t(page), _t(now), land_ok=tok)
            assert hot_none is None and data_none is None
        else:
            jst, jrg, jhot, jslot, jdata, jinfo = jwait(
                jst, jrg, jhot, jnp.asarray(page), jnp.asarray(now), jok)
            tst, trg, thot, tslot, tdata, tinfo = tp.pool_wait(
                tst, trg, thot, tpool, _t(page), _t(now), land_ok=tok)
            _same_tree(jdata, tdata, f"data {step}")
            _same_tree(jhot, thot, f"hot {step}")
        np.testing.assert_array_equal(np.asarray(jslot), tslot.numpy())
        _same_tree(dict(jinfo), tinfo, f"info {step}")
        _same_tree(dict(jst), tst, f"state {step}")
        _same_tree(dict(jrg), trg, f"ring {step}")


CASES = [pytest.param(ring, asy, tree, budget,
                      id=f"ring{ring}-{'async' if asy else 'sync'}-"
                         f"{'tree' if tree else 'array'}-budget{budget}")
         for ring, asy, tree, budget in (
             (0, False, False, None), (4, False, True, 2),
             (0, True, True, None), (4, True, False, None),
             (4, True, True, 1), (4, True, False, 2))]


@pytest.mark.parametrize("ring,async_dp,tree,budget", CASES)
def test_multi_stream_consume_matches(ring, async_dp, tree, budget):
    pool = _payload(2, tree)
    sched = _schedules(3)
    jg = jps.PrefetchedStream(n_pages=N_PAGES, n_slots=N_SLOTS,
                              page_elems=6, pw_max=4, ring_size=ring)
    tg = tps.PrefetchedStream(n_pages=N_PAGES, n_slots=N_SLOTS,
                              page_elems=6, pw_max=4, ring_size=ring)
    jst, jsums, jinfo = jps.multi_stream_consume(
        jax.tree.map(jnp.asarray, pool), jnp.asarray(sched), jg,
        async_datapath=async_dp, link_budget=budget)
    tpool = {k: _t(v) for k, v in pool.items()} if tree else _t(pool)
    tst, tsums, tinfo = tps.multi_stream_consume(
        tpool, _t(sched), tg, async_datapath=async_dp, link_budget=budget)
    _same_tree(jsums, tsums, "sums")
    assert set(jinfo) == set(tinfo)
    _same_tree(dict(jinfo), tinfo, "info")
    for group in ("leap", "pool_meta", "ring", "hot"):
        _same_tree(jst[group], tst[group], group)
    tnp = {k: v.numpy() for k, v in tinfo.items()}
    stats = [tps.stream_stats_at(tst, s) for s in range(S)]
    assert stats == [jps.stream_stats_at(jst, s) for s in range(S)]
    assert ([astuple(e) for e in j_events(
        sched, jinfo, n_pages=N_PAGES, final_stats=stats, step_offset=5)]
        == [astuple(e) for e in t_events(
            sched, tnp, n_pages=N_PAGES, final_stats=stats, step_offset=5)])


def test_single_stream_consume_and_checksum():
    """``stream_consume`` of one ``[T]`` schedule returns ``[T]`` columns,
    continues from a state, and its checksums are the reference's."""
    pool = _payload(4, False)
    sched = _schedules(5)[0]
    jg = jps.PrefetchedStream(n_pages=N_PAGES, n_slots=N_SLOTS, page_elems=6,
                              pw_max=4, ring_size=R)
    tg = tps.PrefetchedStream(n_pages=N_PAGES, n_slots=N_SLOTS, page_elems=6,
                              pw_max=4, ring_size=R)
    jst, jsums, jinfo = jps.stream_consume(jnp.asarray(pool),
                                           jnp.asarray(sched), jg,
                                           async_datapath=True)
    tst, tsums, tinfo = tps.stream_consume(_t(pool), _t(sched), tg,
                                           async_datapath=True)
    assert tsums.shape == (T,) and tinfo["hit"].shape == (T,)
    _same_tree(jsums, tsums, "sums")
    _same_tree(dict(jinfo), tinfo, "info")
    jst, jsums, _ = jps.stream_consume(jnp.asarray(pool),
                                       jnp.asarray(sched[::-1].copy()), jg,
                                       state=jst, async_datapath=True)
    tst, tsums, _ = tps.stream_consume(_t(pool), _t(sched[::-1].copy()), tg,
                                       state=tst, async_datapath=True)
    _same_tree(jsums, tsums, "sums, continued")
    _same_tree(jst["hot"][None], tst["hot"], "hot, continued")
    data = {"k": torch.arange(12.0).reshape(2, 6),
            "v": -torch.ones(2, 3)}
    want = jps._payload_checksum({"k": jnp.arange(6.0), "v": -jnp.ones(3)})
    assert float(tps._payload_checksum(data)[0]) == float(want)


@pytest.mark.parametrize("tree", [False, True])
def test_ring_size_zero_is_the_sync_path_bitwise(tree):
    pool = _payload(6, tree)
    tpool = {k: _t(v) for k, v in pool.items()} if tree else _t(pool)
    sched = _t(_schedules(7))
    tg = tps.PrefetchedStream(n_pages=N_PAGES, n_slots=N_SLOTS, page_elems=6,
                              pw_max=4, ring_size=0)
    a = tps.multi_stream_consume(tpool, sched, tg, async_datapath=True)
    b = tps.multi_stream_consume(tpool, sched, tg, async_datapath=False)
    assert torch.equal(a[1], b[1])
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k
    for group in ("leap", "pool_meta", "hot"):
        leaves_a = a[0][group] if isinstance(a[0][group], dict) else {
            "": a[0][group]}
        leaves_b = b[0][group] if isinstance(b[0][group], dict) else {
            "": b[0][group]}
        for k in leaves_a:
            assert torch.equal(leaves_a[k], leaves_b[k]), (group, k)
    assert torch.equal(a[0]["ring"]["now"], b[0]["ring"]["now"] + T)
