"""Port: the paged pool's metadata transactions, batched over streams, give
the same state dicts, outputs and ``pool_stats`` as the reference vmapped
over the same streams — lazy and eager, with and without the ring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pool as jp  # noqa: E402
from repro_torch.core import pool as tp  # noqa: E402

CPU = "cpu"
S, N_PAGES, N_SLOTS, R = 3, 24, 10, 4


def _same_tree(j: dict, t: dict, where: str) -> None:
    assert set(j) == set(t), where
    for k in j:
        np.testing.assert_array_equal(np.asarray(j[k]), t[k].numpy(),
                                      err_msg=f"{where}: {k}")


def _jinit(ring: bool):
    one = jp.pool_init(N_PAGES, N_SLOTS)
    st = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape), one)
    rg = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                      jp.ring_init(R if ring else 0))
    return st, rg


def _t(a, dtype=None):
    a = np.asarray(a)
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


@pytest.mark.parametrize("lazy", [True, False])
def test_sync_access_sequences(lazy):
    rng = np.random.default_rng(10 + lazy)
    jst, _ = _jinit(False)
    tst = tp.pool_init(N_PAGES, N_SLOTS, S, device=CPU)
    _same_tree(jst, tst, "init")
    K = 4
    jacc = jax.vmap(lambda st, p, f, v: jp.pool_access(st, None, None, p, f,
                                                       v, lazy=lazy))
    for step in range(30):
        pages = rng.integers(-2, N_PAGES + 2, (S, K)).astype(np.int32)
        if step % 3 == 0:     # revisit a small working set: hits + evictions
            pages = rng.integers(0, 6, (S, K)).astype(np.int32)
        pf = rng.random((S, K)) < 0.4
        val = rng.random((S, K)) < 0.85
        jst, _, jslots, jinfo = jacc(jst, jnp.asarray(pages), jnp.asarray(pf),
                                     jnp.asarray(val))
        tst, _, tslots, tinfo = tp.pool_access(tst, None, None, _t(pages),
                                               _t(pf), _t(val), lazy=lazy)
        _same_tree(jst, tst, f"step {step}")
        np.testing.assert_array_equal(np.asarray(jslots), tslots.numpy())
        _same_tree(jinfo, tinfo, f"info {step}")
    for s in range(S):
        js = jp.pool_stats(jax.tree.map(lambda x: x[s], jst))
        ts = tp.pool_stats({k: v[s] for k, v in tst.items()})
        assert js == ts


@pytest.mark.parametrize("lazy", [True, False])
def test_async_issue_wait_invalidate_sequences(lazy):
    rng = np.random.default_rng(20 + lazy)
    jst, jrg = _jinit(True)
    tst = tp.pool_init(N_PAGES, N_SLOTS, S, device=CPU)
    trg = tp.ring_init(R, S, device=CPU)
    _same_tree(jrg, trg, "ring init")
    D = 3
    jwait = jax.vmap(lambda st, rg, p, v, now, ok: jp.pool_wait_batch(
        st, rg, None, None, p, v, now, lazy=lazy, land_ok=ok))
    jissue = jax.vmap(lambda st, rg, p, v, now, d, sq: jp.pool_issue(
        st, rg, p, v, now, d, seq=sq))
    jinv = jax.vmap(jp.pool_invalidate)
    now = np.zeros((S,), np.int32)
    for step in range(30):
        op = step % 3
        if op == 0:
            pages = rng.integers(-1, N_PAGES + 2, (S, 3)).astype(np.int32)
            val = rng.random((S, 3)) < 0.9
            delay = rng.integers(0, 3, (S, 3)).astype(np.int32)
            seq = rng.integers(0, 100, (S, 3)).astype(np.int32)
            jst, jrg = jissue(jst, jrg, jnp.asarray(pages), jnp.asarray(val),
                              jnp.asarray(now), jnp.asarray(delay),
                              jnp.asarray(seq))
            tst, trg = tp.pool_issue(tst, trg, _t(pages), _t(val), _t(now),
                                     _t(delay), seq=_t(seq))
        elif op == 1:
            pages = rng.integers(-1, N_PAGES, (S, D)).astype(np.int32)
            val = rng.random((S, D)) < 0.9
            ok = rng.random((S, R)) < 0.7
            jst, jrg, _, jslots, jinfo = jwait(
                jst, jrg, jnp.asarray(pages), jnp.asarray(val),
                jnp.asarray(now), jnp.asarray(ok))
            tst, trg, _, tslots, tinfo = tp.pool_wait_batch(
                tst, trg, None, None, _t(pages), _t(val), _t(now), lazy=lazy,
                land_ok=_t(ok))
            np.testing.assert_array_equal(np.asarray(jslots), tslots.numpy())
            _same_tree(jinfo, tinfo, f"wait info {step}")
            now = now + 1
        else:
            pages = rng.integers(-1, N_PAGES, (S, 2)).astype(np.int32)
            val = rng.random((S, 2)) < 0.8
            jst, jrg = jinv(jst, jrg, jnp.asarray(pages), jnp.asarray(val))
            tst, trg = tp.pool_invalidate(tst, trg, _t(pages), _t(val))
        _same_tree(jst, tst, f"state step {step}")
        _same_tree(jrg, trg, f"ring step {step}")
    for s in range(S):
        js = jp.pool_stats(jax.tree.map(lambda x: x[s], jst),
                           jax.tree.map(lambda x: x[s], jrg))
        one = lambda d: {k: v[s] for k, v in d.items()}
        ts = tp.pool_stats(one(tst), one(trg))
        assert js == ts
        # §4.3: every issued prefetch ended up exactly one way
        assert ts["prefetch_issued"] == (ts["prefetch_hits"]
                                         + ts["pollution"]
                                         + ts["inflight_at_end"]
                                         + ts["resident_unused"])


def test_link_grants_and_page_home_match():
    rng = np.random.default_rng(5)
    ring = {"page": rng.integers(-1, 40, (4, 6)).astype(np.int32),
            "ready": rng.integers(0, 5, (4, 6)).astype(np.int32),
            "seq": rng.permutation(24).reshape(4, 6).astype(np.int32)}
    now = rng.integers(0, 5, 4).astype(np.int32)
    homes = rng.integers(0, 2, (4, 6)).astype(np.int32)
    caps = np.array([3, 1], np.int32)
    jg = jp.link_grants_sharded({k: jnp.asarray(v) for k, v in ring.items()},
                                jnp.asarray(now), jnp.asarray(caps),
                                jnp.asarray(homes))
    tg = tp.link_grants_sharded({k: _t(v) for k, v in ring.items()}, _t(now),
                                _t(caps), _t(homes))
    np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
    pages = np.arange(-3, 44, dtype=np.int32)
    for placement in ("block", "interleave"):
        np.testing.assert_array_equal(
            np.asarray(jp.page_home(jnp.asarray(pages), 40, 4, placement)),
            tp.page_home(_t(pages), 40, 4, placement).numpy())
        np.testing.assert_array_equal(
            np.asarray(jp.page_local(jnp.asarray(pages), 40, 4, placement)),
            tp.page_local(_t(pages), 40, 4, placement).numpy())


@pytest.mark.parametrize("lazy,K", [(True, N_SLOTS + 1), (False, 6)])
def test_geometry_floor_raises(lazy, K):
    st = tp.pool_init(N_PAGES, N_SLOTS, 2, device=CPU)
    z = torch.zeros((2, K), dtype=torch.int32)
    b = torch.ones((2, K), dtype=torch.bool)
    with pytest.raises(ValueError, match="n_slots"):
        tp.pool_access(st, None, None, z, b, b, lazy=lazy)
    rg = tp.ring_init(R, 2, device=CPU)
    with pytest.raises(ValueError, match="n_slots"):
        tp.pool_wait_batch(st, rg, None, None, z, b, torch.zeros(2, dtype=torch.int32),
                           lazy=lazy)


def test_payload_arguments_not_ported():
    """Payload-carrying ``pool_access`` (a ``{"k", "v"}`` pytree) moves the
    same bytes into the same hot slots as the reference's, eager and
    lazy. (The name is kept so the test's id stays: payloads used to
    raise here.)"""
    rng = np.random.default_rng(30)
    pool = {k: rng.standard_normal((N_PAGES, 2, 3)).astype(np.float32)
            for k in ("k", "v")}
    K = 4
    for lazy in (True, False):
        jst, _ = _jinit(False)
        jhot = {k: jnp.zeros((S, N_SLOTS, 2, 3)) for k in pool}
        tst = tp.pool_init(N_PAGES, N_SLOTS, S, device=CPU)
        thot = {k: torch.zeros((S, N_SLOTS, 2, 3)) for k in pool}
        jacc = jax.vmap(lambda st, h, p, f, v: jp.pool_access(
            st, h, {k: jnp.asarray(a) for k, a in pool.items()}, p, f, v,
            lazy=lazy))
        for step in range(12):
            pages = rng.integers(-1, N_PAGES + 1, (S, K)).astype(np.int32)
            pf = rng.random((S, K)) < 0.4
            val = rng.random((S, K)) < 0.9
            jst, jhot, jslots, _ = jacc(jst, jhot, jnp.asarray(pages),
                                        jnp.asarray(pf), jnp.asarray(val))
            tst, thot, tslots, _ = tp.pool_access(
                tst, thot, {k: torch.from_numpy(a) for k, a in pool.items()},
                _t(pages), _t(pf), _t(val), lazy=lazy)
            _same_tree(jst, tst, f"lazy={lazy} step {step}")
            np.testing.assert_array_equal(np.asarray(jslots), tslots.numpy())
            for k in pool:
                assert np.asarray(jhot[k]).tobytes() == thot[k].numpy(
                ).tobytes(), (lazy, step, k)
