"""Port: the §12 lifecycle's transactions, policy and page codec against the
reference.

* the tier transactions of ``core/pool.py`` (``tier_init``,
  ``_tier_scatter_idx``, ``tier_migrate``, ``tier_demote``,
  ``tier_promote`` with its snapshot, ``tier_heat_decay``, ``tier_touch``,
  ``tier_stats``) and the migration class of ``link_grants_sharded``, on
  random inputs with duplicate and dropped entries: equal tables;
* ``propose_migrations``, ``revalidate_proposals`` and
  ``select_demotions`` of ``paging/lifecycle.py``: equal outputs;
* ``PageLifecycle`` over a scripted sequence of steps: equal tables and
  reports;
* the page codec: bitwise equal to the reference's ``page_roundtrip``
  called eagerly on one page at a time, in float32 and bfloat16; the
  all-zero page exact; the ``scale / 2`` bound; and the page ``[2^-9]``
  that a second round trip moves, as in the reference.

Every comparison of integers and bytes is exact; the codec's bound is the
reference's (``scale / 2`` with 1e-5 of float32 headroom).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pool as jpool  # noqa: E402
from repro.paging import lifecycle as jlc  # noqa: E402
from repro.runtime import compression as jcodec  # noqa: E402
from repro_torch.core import pool as tpool  # noqa: E402
from repro_torch.paging import lifecycle as tlc  # noqa: E402
from repro_torch.runtime import compression as tcodec  # noqa: E402

N_PAGES, G = 40, 4
CFG = dict(mig_per_stream=3, lead=1, cooldown=5, compressed=True,
           far_capacity=20, demote_per_step=4, decompress_delay=2)


def _same(j, t, where):
    j = np.asarray(j)
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    assert j.dtype == t.dtype and j.shape == t.shape, where
    assert j.tobytes() == t.tobytes(), where


def _same_tier(jt, tt, where=""):
    assert set(jt) == set(tt)
    for k in jt:
        _same(jt[k], tt[k], f"{where} {k}")


def _random_tier(rng, placement="interleave"):
    """Reference and port tables with random homes, bits, heat and
    stamps."""
    tier = {
        "home": rng.integers(0, G, N_PAGES).astype(np.int32),
        "comp": rng.random(N_PAGES) < 0.4,
        "heat": rng.integers(0, 30, N_PAGES).astype(np.int32),
        "last_mig": np.where(rng.random(N_PAGES) < 0.5,
                             rng.integers(0, 12, N_PAGES),
                             tpool._TIER_NEVER).astype(np.int32),
        "n_migrations": np.int32(3), "n_demotions": np.int32(1),
        "n_promotions": np.int32(2)}
    tier["heat"][rng.random(N_PAGES) < 0.4] = 0
    return ({k: jnp.asarray(v) for k, v in tier.items()},
            {k: torch.as_tensor(np.asarray(v)) for k, v in tier.items()})


def _batch(rng, n, distinct):
    """Page ids (some out of range, some duplicated) and a validity mask;
    with ``distinct`` the valid ones are distinct in-range pages."""
    pages = rng.integers(-3, N_PAGES + 3, n).astype(np.int32)
    pages[1] = pages[0]                                # a duplicate
    ok = rng.random(n) < 0.6
    if distinct:
        pages[ok] = rng.choice(N_PAGES, int(ok.sum()), replace=False)
    return pages, ok


@pytest.mark.parametrize("placement", ["block", "interleave"])
def test_tier_init_and_stats(placement):
    jt = jpool.tier_init(N_PAGES, G, placement)
    tt = tpool.tier_init(N_PAGES, G, placement, device="cpu")
    _same_tier(jt, tt, placement)
    assert tpool._TIER_NEVER == jpool._TIER_NEVER
    rng = np.random.default_rng(1)
    jt, tt = _random_tier(rng)
    assert tpool.tier_stats(tt) == jpool.tier_stats(jt)
    _same(jlc.static_home_map(N_PAGES, G, placement),
          tlc.static_home_map(N_PAGES, G, placement, device="cpu"),
          "static_home_map")


@pytest.mark.parametrize("seed", range(4))
def test_tier_transactions_match(seed):
    rng = np.random.default_rng(seed)
    jt, tt = _random_tier(rng)
    pages, ok = _batch(rng, 12, distinct=False)
    jp, jo = jnp.asarray(pages), jnp.asarray(ok)
    tp, to = torch.from_numpy(pages), torch.from_numpy(ok)
    _same(jpool._tier_scatter_idx(jt, jp, jo),
          tpool._tier_scatter_idx(tt, tp, to).to(torch.int32), "scatter idx")
    _same_tier(jpool.tier_heat_decay(jt), tpool.tier_heat_decay(tt), "decay")
    _same_tier(jpool.tier_touch(jt, jp, jo, 8),
               tpool.tier_touch(tt, tp, to, 8), "touch")
    # promotion against a snapshot, and against the current table
    snap = rng.random(N_PAGES) < 0.5
    j2, jn = jpool.tier_promote(jt, jp, jo, jnp.asarray(snap))
    t2, tn = tpool.tier_promote(tt, tp, to, torch.from_numpy(snap))
    _same_tier(j2, t2, "promote snapshot")
    _same(jn, tn, "n_promoted")
    j2, jn = jpool.tier_promote(jt, jp, jo)
    t2, tn = tpool.tier_promote(tt, tp, to)
    _same_tier(j2, t2, "promote")
    _same(jn, tn, "n_promoted")
    # migrate and demote take distinct valid pages; dropped ones may repeat
    pages, ok = _batch(rng, 12, distinct=True)
    dests = rng.integers(0, G, 12).astype(np.int32)
    jp, jo = jnp.asarray(pages), jnp.asarray(ok)
    tp, to = torch.from_numpy(pages), torch.from_numpy(ok)
    _same_tier(jpool.tier_migrate(jt, jp, jnp.asarray(dests), jo,
                                  jnp.int32(9)),
               tpool.tier_migrate(tt, tp, torch.from_numpy(dests), to, 9),
               "migrate")
    _same_tier(jpool.tier_demote(jt, jp, jo, jnp.int32(7)),
               tpool.tier_demote(tt, tp, to, 7), "demote")


@pytest.mark.parametrize("seed", range(4))
def test_link_grants_migration_class_matches(seed):
    """Prefetch grants and the third class: leftover capacity per source
    NIC, ranked by proposal order."""
    rng = np.random.default_rng(10 + seed)
    S, R, M = 3, 6, 2
    page = np.where(rng.random((S, R)) < 0.8,
                    rng.integers(0, N_PAGES, (S, R)), -1).astype(np.int32)
    ring = {"page": page,
            "ready": rng.integers(0, 6, (S, R)).astype(np.int32),
            "seq": rng.permutation(S * R).reshape(S, R).astype(np.int32)}
    now = rng.integers(2, 6, S).astype(np.int32)
    caps = rng.integers(0, 4, G).astype(np.int32)
    homes = rng.integers(0, G, (S, R)).astype(np.int32)
    msrc = rng.integers(0, G, (S, M)).astype(np.int32)
    mvalid = rng.random((S, M)) < 0.7
    mseq = rng.permutation(S * M).reshape(S, M).astype(np.int32)
    j = jpool.link_grants_sharded(
        {k: jnp.asarray(v) for k, v in ring.items()}, jnp.asarray(now),
        jnp.asarray(caps), jnp.asarray(homes), jnp.asarray(msrc),
        jnp.asarray(mvalid), jnp.asarray(mseq))
    t = tpool.link_grants_sharded(
        {k: torch.from_numpy(v) for k, v in ring.items()},
        torch.from_numpy(now), torch.from_numpy(caps),
        torch.from_numpy(homes), torch.from_numpy(msrc),
        torch.from_numpy(mvalid), torch.from_numpy(mseq))
    _same(j[0], t[0], "grants")
    _same(j[1], t[1], "mig_ok")
    # without proposals: the two-class grants alone
    _same(j[0], tpool.link_grants_sharded(
        {k: torch.from_numpy(v) for k, v in ring.items()},
        torch.from_numpy(now), torch.from_numpy(caps),
        torch.from_numpy(homes)), "grants alone")


@pytest.mark.parametrize("seed", range(4))
def test_policy_functions_match(seed):
    rng = np.random.default_rng(20 + seed)
    S, t = 4, 14
    jcfg, tcfg = jlc.MigrationCfg(**CFG), tlc.MigrationCfg(**CFG)
    jt, tt = _random_tier(rng)
    leap = {"trend": rng.integers(-3, 4, S).astype(np.int32),
            "has_trend": rng.random(S) < 0.8}
    pages = rng.integers(0, N_PAGES, S).astype(np.int32)
    homes_s = (np.arange(S) % G).astype(np.int32)
    j = jlc.propose_migrations(
        {k: jnp.asarray(v) for k, v in leap.items()}, jnp.asarray(pages),
        jnp.asarray(homes_s), jt, jnp.int32(t), N_PAGES, 4, jcfg)
    tp = tlc.propose_migrations(
        {k: torch.from_numpy(v) for k, v in leap.items()},
        torch.from_numpy(pages), torch.from_numpy(homes_s), tt, t, N_PAGES,
        4, tcfg)
    for name, a, b in zip(("mpages", "mdest", "mvalid", "mseq"), j, tp):
        _same(a, b, name)
    assert bool(tp[2].any())
    # carried proposals with a page proposed twice: lowest seq wins
    mp = rng.integers(0, N_PAGES, (S, 3)).astype(np.int32)
    mp[1, 0] = mp[0, 2] = mp[2, 1]
    md = rng.integers(0, G, (S, 3)).astype(np.int32)
    mv = rng.random((S, 3)) < 0.8
    mv[1, 0] = mv[0, 2] = mv[2, 1] = True
    ms = rng.permutation(S * 3).reshape(S, 3).astype(np.int32)
    j = jlc.revalidate_proposals(*(jnp.asarray(a) for a in (mp, md, mv, ms)),
                                 jt, jnp.int32(t), jcfg)
    tr = tlc.revalidate_proposals(*(torch.from_numpy(a)
                                    for a in (mp, md, mv, ms)), tt, t, tcfg)
    _same(j[0], tr[0], "mvalid'")
    _same(j[1], tr[1], "msrc")
    for cap in (5, 20, 39):
        jc = jlc.MigrationCfg(**dict(CFG, far_capacity=cap))
        tc = tlc.MigrationCfg(**dict(CFG, far_capacity=cap))
        j = jlc.select_demotions(jt, jnp.int32(t), jc)
        td = tlc.select_demotions(tt, t, tc)
        _same(j[0], td[0], f"victims at capacity {cap}")
        _same(j[1], td[1], f"ok at capacity {cap}")


def test_config_validation_and_resolve():
    for bad in (dict(mig_per_stream=0), dict(lead=0), dict(cooldown=0),
                dict(compressed=True), dict(demote_per_step=0),
                dict(decompress_delay=-1)):
        with pytest.raises(ValueError) as je:
            jlc.MigrationCfg(**bad)
        with pytest.raises(ValueError, match=str(je.value)):
            tlc.MigrationCfg(**bad)
    assert tlc.resolve(None) is None
    assert tlc.resolve(tlc.MigrationCfg(enabled=False)) is None
    cfg = tlc.MigrationCfg()
    assert tlc.resolve(cfg) is cfg
    import dataclasses
    assert ([(f.name, f.default) for f in dataclasses.fields(jlc.MigrationCfg)]
            == [(f.name, f.default)
                for f in dataclasses.fields(tlc.MigrationCfg)])


@pytest.mark.parametrize("placement", ["block", "interleave"])
def test_page_lifecycle_mirror_matches(placement):
    """A scripted run: heat, migrations (some inside their cooldown),
    promotions of rewritten pages and demotions, with and without a safe
    mask."""
    rng = np.random.default_rng(3)
    cfg = dict(CFG, far_capacity=24, cooldown=3)
    j = jlc.PageLifecycle(N_PAGES, G, placement, jlc.MigrationCfg(**cfg))
    t = tlc.PageLifecycle(N_PAGES, G, placement, tlc.MigrationCfg(**cfg),
                          device="cpu")
    for step in range(14):
        for lc in (j, t):
            lc.begin_step()
        touched = rng.integers(-2, N_PAGES + 2, 10)
        moves = rng.integers(-1, N_PAGES + 1, 3)
        dest = int(rng.integers(0, G))
        written = rng.integers(0, N_PAGES, 4)
        safe = rng.random(N_PAGES) < 0.7 if step % 2 else None
        for lc in (j, t):
            lc.touch(touched)
        assert t.migrate_toward(moves, dest) == j.migrate_toward(moves, dest)
        assert t.promote(written) == j.promote(written)
        assert t.demote_victims(safe) == j.demote_victims(safe)
        for k in ("home", "comp", "heat", "last_mig"):
            np.testing.assert_array_equal(getattr(j, k), getattr(t, k),
                                          err_msg=f"step {step} {k}")
        assert t.report() == j.report()
        _same(j.home_map(), t.home_map(), "home_map")
        _same(j.comp_map(), t.comp_map(), "comp_map")
    rep = t.report()
    assert rep["migrations"] > 0 and rep["demotions"] > 0
    assert rep["promotions"] > 0
    assert rep["uncompressed"] + rep["compressed"] == rep["n_pages"]
    off = tlc.PageLifecycle(N_PAGES, G, placement,
                            tlc.MigrationCfg(cooldown=3), device="cpu")
    off.begin_step()
    assert off.demote_victims() == []               # no compressed tier


# --------------------------------------------------------------------------
# the page codec
# --------------------------------------------------------------------------
def _pages(seed, dtype, n=8, shape=(16, 2, 8)):
    """``n`` pages of a KV layout, each at its own magnitude, as the
    reference's dtype and the port's."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n,) + shape)
         * rng.uniform(1e-3, 1e2, (n, 1, 1, 1))).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_codec_bitwise_equal_to_eager_reference(dtype, seed):
    """Each page against the reference's ``page_roundtrip`` called eagerly
    on that page; the batched form equals the one-page form."""
    jx, tx = _pages(seed, dtype)
    batched = tcodec.roundtrip_pages(tx)
    for i in range(jx.shape[0]):
        want = jcodec.page_roundtrip(jx[i])
        got = tcodec.page_roundtrip(tx[i])
        assert got.dtype == tx.dtype and got.shape == tx[i].shape
        _same(np.asarray(want.astype(jnp.float32)), got.float(), f"page {i}")
        assert torch.equal(batched[i], got)
        jq, js = jcodec.compress_page(jx[i])
        tq, ts = tcodec.compress_page(tx[i])
        _same(jq, tq, "q")
        _same(js, ts, "scale")
        _same(jcodec.decompress_page(jq, js),
              tcodec.decompress_page(tq, ts), "decompress")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_bound_and_zero_page(dtype):
    """Every element within ``scale / 2`` of the page (the reference's
    float32 headroom); the all-zero page comes back exactly."""
    _, tx = _pages(7, dtype, n=16)
    for page in tx:
        q, scale = tcodec.compress_page(page)
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        out = tcodec.decompress_page(q, scale)
        bound = float(scale) / 2 * (1 + 1e-5)
        assert float((out - page.float()).abs().max()) < bound + 1e-30
    zero = torch.zeros((64,), dtype=getattr(torch, dtype))
    q, scale = tcodec.compress_page(zero)
    assert int(q.abs().sum()) == 0
    assert torch.equal(tcodec.page_roundtrip(zero), zero)
    assert torch.equal(tcodec.roundtrip_pages(torch.zeros((3, 4, 2))),
                       torch.zeros((3, 4, 2)))


def test_codec_is_not_idempotent_on_the_reference_counterexample():
    """``[2^-9]``: its second round trip moves it, in the port as in the
    reference, by the same bytes."""
    page = np.array([2.0 ** -9], np.float32)
    j1 = jcodec.page_roundtrip(jnp.asarray(page))
    j2 = jcodec.page_roundtrip(j1)
    t1 = tcodec.page_roundtrip(torch.from_numpy(page))
    t2 = tcodec.page_roundtrip(t1)
    _same(j1, t1, "once")
    _same(j2, t2, "twice")
    assert not torch.equal(t1, t2)


def count_codec_forms(n_batches: int = 100, seed: int = 0) -> dict:
    """How often the port's codec differs from three forms of the
    reference's on a batch of 8 pages ``[16, 2, 128]`` (each page at its
    own magnitude): called eagerly page by page, under ``jax.jit`` page by
    page, and as ``jax.jit(jax.vmap(page_roundtrip))`` (the reference
    engine's ``_roundtrip_pages``). Returns, per dtype, the batches that
    differ and the largest difference in units of the page's scale."""
    import jax
    jit, vmap = jax.jit(jcodec.page_roundtrip), jax.jit(
        jax.vmap(jcodec.page_roundtrip))
    out = {}
    for dtype in ("float32", "bfloat16"):
        diff = {"eager": 0, "jit": 0, "vmap": 0}
        worst = 0.0
        for b in range(n_batches):
            jx, tx = _pages(seed * 1000 + b, dtype, shape=(16, 2, 128))
            got = tcodec.roundtrip_pages(tx).float().numpy()
            forms = {
                "eager": np.stack([np.asarray(jcodec.page_roundtrip(p)
                                              .astype(jnp.float32))
                                   for p in jx]),
                "jit": np.stack([np.asarray(jit(p).astype(jnp.float32))
                                 for p in jx]),
                "vmap": np.asarray(vmap(jx).astype(jnp.float32))}
            scale = np.abs(got).reshape(8, -1).max(1) / 127
            for k, want in forms.items():
                if not np.array_equal(want, got):
                    diff[k] += 1
                d = np.abs(want - got).reshape(8, -1).max(1) / scale
                worst = max(worst, float(d.max())) if k != "eager" else worst
        out[dtype] = dict(batches=n_batches, differing=diff,
                          max_diff_in_scales=worst)
    return out


if __name__ == "__main__":
    # PYTHONPATH=src python tests/test_torch_lifecycle.py
    import json
    print(json.dumps(count_codec_forms()))
