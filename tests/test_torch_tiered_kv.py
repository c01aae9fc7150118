"""Port: the tiered paged-KV sweep and attention against the JAX reference.

* ``tiered_sweep`` sync / async x ``link_budget`` {None, 1}: the same
  per-chunk ``info`` columns, the same ``decode_sweep_events`` and the same
  state (controller, pool metadata, ring, hot bytes) as the reference.
* attention from the hot tier at 2e-5 against the reference's.
* tiered == flat, bitwise, inside the port in every mode it has.
* the ``convert`` hand-over: a reference state after a few sweeps, carried
  across, sweeps on identically on both sides.

The reference runs with ``use_kernel=False`` (its documented identical-
bytes gather; its async kernel is red on this JAX).
"""

from dataclasses import astuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs.trace import decode_sweep_events as j_events  # noqa: E402
from repro.paging import tiered_kv as jt  # noqa: E402
from repro_torch.convert import (tiered_state_from_numpy,  # noqa: E402
                                 tree_from_numpy, tree_to_numpy)
from repro_torch.obs.trace import decode_sweep_events as t_events  # noqa: E402
from repro_torch.paging import tiered_kv as tt  # noqa: E402
from repro_torch.paging.kv_cache import paged_decode_attention  # noqa: E402

B, NPPS, PS, HKV, HQ, DH = 4, 8, 4, 2, 4, 8
N_PAGES = B * NPPS
CPU = "cpu"


def _geoms(ring=8, chunk=2, small=True):
    kw = dict(chunk=chunk, pw_max=4, ring_size=ring)
    n_slots = tt.tiered_min_slots(NPPS, tt.TieredKV(N_PAGES, 1, PS, HKV, DH,
                                                    **kw))
    n_slots = n_slots if small else N_PAGES
    return (jt.TieredKV(N_PAGES, n_slots, PS, HKV, DH, use_kernel=False,
                        **kw),
            tt.TieredKV(N_PAGES, n_slots, PS, HKV, DH, **kw))


def _inputs(seed=0, stride=3):
    rng = np.random.default_rng(seed)
    cold = {k: rng.standard_normal((N_PAGES, PS, HKV, DH)).astype(np.float32)
            for k in ("k", "v")}
    base = np.arange(B)[:, None] * NPPS
    rows = (base + (np.arange(NPPS)[None] * stride) % NPPS).astype(np.int32)
    rows[1, 5:] = -1                               # a ragged row
    q = rng.standard_normal((B, 1, HQ, DH)).astype(np.float32)
    lengths = np.array([29, 17, 32, 5], np.int32)
    return cold, rows, q, lengths


def _jstate(st):
    return jax.tree.map(np.asarray, st)


def _assert_state_equal(jst, tst, where=""):
    jn = _jstate(jst)
    tn = tree_to_numpy(tst)
    for group in ("leap", "pool_meta", "ring", "hot"):
        for k in jn[group]:
            np.testing.assert_array_equal(jn[group][k], tn[group][k],
                                          err_msg=f"{where} {group}.{k}")


@pytest.mark.parametrize("async_dp", [False, True])
@pytest.mark.parametrize("budget", [None, 1])
def test_sweep_info_events_and_state_match(async_dp, budget):
    cold, rows, q, lengths = _inputs()
    jg, tg = _geoms()
    jst = jt.tiered_init(jg, B, jnp.float32)
    tst = tt.tiered_init(tg, B, torch.float32, device=CPU)
    jcold = {k: jnp.asarray(v) for k, v in cold.items()}
    tcold = tree_from_numpy(cold, CPU)
    inv = np.full((B, 2), -1, np.int32)
    inv[:, 0] = rows[:, 2]
    for sweep in range(3):                 # warm hot tiers + a write between
        jst, jinfo = jt.tiered_sweep(jst, jcold, jnp.asarray(rows), jg,
                                     async_datapath=async_dp,
                                     link_budget=budget)
        tst, tinfo = tt.tiered_sweep(tst, tcold, torch.from_numpy(rows), tg,
                                     async_datapath=async_dp,
                                     link_budget=budget)
        assert set(jinfo) == set(tinfo)
        tnp = {k: v.numpy() for k, v in tinfo.items()}
        for k in jinfo:
            np.testing.assert_array_equal(np.asarray(jinfo[k]), tnp[k],
                                          err_msg=f"sweep {sweep} {k}")
        assert ([astuple(e) for e in j_events(jinfo, step_offset=7)]
                == [astuple(e) for e in t_events(tnp, step_offset=7)])
        _assert_state_equal(jst, tst, f"sweep {sweep}")
        jst = jt.tiered_invalidate(jst, jnp.asarray(inv))
        tst = tt.tiered_invalidate(tst, torch.from_numpy(inv))
        _assert_state_equal(jst, tst, f"invalidate {sweep}")
    for s in range(B):
        assert jt.tiered_stats(jst, s) == tt.tiered_stats(tst, s)


@pytest.mark.parametrize("mode", ["ref", "kernel", "fused"])
def test_attention_vs_jax_and_bitwise_flat_pin(mode):
    cold, rows, q, lengths = _inputs(seed=1, stride=1)
    jg, tg = _geoms()
    jst = jt.tiered_init(jg, B, jnp.float32)
    tst = tt.tiered_init(tg, B, torch.float32, device=CPU)
    jst, jout, _, jok = jt.tiered_decode_step(
        jst, {k: jnp.asarray(v) for k, v in cold.items()}, jnp.asarray(q),
        jnp.asarray(rows), jnp.asarray(lengths), jg, async_datapath=True,
        attn_kernel=mode)
    tcold = tree_from_numpy(cold, CPU)
    tq, trows, tlen = (torch.from_numpy(a) for a in (q, rows, lengths))
    tst, tout, _, tok = tt.tiered_decode_step(
        tst, tcold, tq, trows, tlen, tg, async_datapath=True,
        attn_kernel=mode)
    assert bool(jok) and bool(tok)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=2e-5)
    pool = {k: v[None] for k, v in tcold.items()}
    flat = paged_decode_attention(tq, pool, 0, trows, tlen,
                                  use_kernel=(mode != "ref"))
    assert torch.equal(tout, flat)                 # tiered == flat, bitwise


@pytest.mark.parametrize("async_dp", [False, True])
def test_every_mode_bitwise_equal_on_a_full_hot_tier(async_dp):
    cold, rows, q, lengths = _inputs(seed=2)
    _, tg = _geoms(ring=0 if not async_dp else 8, small=False)
    tst = tt.tiered_init(tg, B, torch.float32, device=CPU)
    tcold = tree_from_numpy(cold, CPU)
    trows = torch.from_numpy(rows)
    tst, _ = tt.tiered_sweep(tst, tcold, trows, tg, async_datapath=async_dp)
    tq, tlen = torch.from_numpy(q), torch.from_numpy(lengths)
    pool = {k: v[None] for k, v in tcold.items()}
    flat = paged_decode_attention(tq, pool, 0, trows, tlen)
    for mode in ("ref", "kernel", "fused"):
        out, ok = tt.tiered_attention(tq, tst, trows, tlen, attn_kernel=mode)
        assert bool(ok)
        assert torch.equal(out, flat), mode


def test_convert_hand_over_then_one_more_sweep():
    cold, rows, q, lengths = _inputs(seed=3)
    jg, tg = _geoms()
    jcold = {k: jnp.asarray(v) for k, v in cold.items()}
    jst = jt.tiered_init(jg, B, jnp.float32)
    for _ in range(2):
        jst, _ = jt.tiered_sweep(jst, jcold, jnp.asarray(rows), jg,
                                 async_datapath=True)
    tst = tiered_state_from_numpy(_jstate(jst), CPU)
    _assert_state_equal(jst, tst, "hand-over")
    rows2 = np.roll(rows, 1, axis=0)
    jst, jinfo = jt.tiered_sweep(jst, jcold, jnp.asarray(rows2), jg,
                                 async_datapath=True)
    tst, tinfo = tt.tiered_sweep(tst, tree_from_numpy(cold, CPU),
                                 torch.from_numpy(rows2), tg,
                                 async_datapath=True)
    for k in jinfo:
        np.testing.assert_array_equal(np.asarray(jinfo[k]), tinfo[k].numpy())
    _assert_state_equal(jst, tst, "after")


def test_bf16_hand_over_round_trips_bytes():
    jg, _ = _geoms()
    jst = _jstate(jt.tiered_init(jg, 2, jnp.bfloat16))
    jst["hot"]["k"] = np.asarray(jnp.asarray(
        np.random.default_rng(4).standard_normal(jst["hot"]["k"].shape),
        jnp.bfloat16))
    jst["hot"]["k"].setflags(write=False)
    tst = tiered_state_from_numpy(jst, CPU)
    assert tst["hot"]["k"].dtype == torch.bfloat16
    back = tree_to_numpy(tst)
    assert back["hot"]["k"].tobytes() == jst["hot"]["k"].tobytes()


def test_undersized_hot_pool_and_unported_options_raise():
    """An undersized hot tier and a mesh of the wrong fabric size raise
    (``tests/test_torch_fabric_mesh.py`` runs the mesh plane); the §12
    lifecycle maps at
    their t = 0 values (the static homes, nothing compressed) reduce the
    sweep bitwise to the two-tier sweep; a fabric of more than one shard
    sweeps (``tests/test_torch_sharded.py`` holds it against the
    reference) unless the pool does not split over its shards."""
    _, tg = _geoms()
    small = tt.TieredKV(N_PAGES, 4, PS, HKV, DH)
    cold = tree_from_numpy(_inputs()[0], CPU)
    rows = torch.from_numpy(_inputs()[1])
    with pytest.raises(ValueError, match="tiered_min_slots"):
        tt.tiered_sweep(tt.tiered_init(small, B, torch.float32, CPU), cold,
                        rows, small)
    st = tt.tiered_init(tg, B, torch.float32, CPU)
    from repro_torch.paging.lifecycle import static_home_map
    for async_dp in (False, True):
        two, i2 = tt.tiered_sweep(tt.tiered_init(tg, B, torch.float32, CPU),
                                  cold, rows, tg, async_datapath=async_dp)
        mig, im = tt.tiered_sweep(
            tt.tiered_init(tg, B, torch.float32, CPU), cold, rows, tg,
            async_datapath=async_dp,
            home_map=static_home_map(N_PAGES, 1, "interleave", CPU),
            comp_map=torch.zeros(N_PAGES, dtype=torch.bool),
            decompress_delay=2)
        assert set(i2) == set(im)
        assert all(torch.equal(i2[k], im[k]) for k in i2)
        for group in two:
            for k in two[group]:
                assert torch.equal(two[group][k], mig[group][k]), k
    from repro_torch.paging.sharded_pool import ShardedPoolCfg
    import types
    mesh = types.SimpleNamespace(mesh_dim_names=("fabric",), shape=(4,))
    with pytest.raises(ValueError, match="mesh fabric axis 4 != n_shards 2"):
        tt.tiered_sweep(st, cold, rows, tg, fabric=ShardedPoolCfg(n_shards=2),
                        mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        tt.tiered_sweep(st, cold, rows, tg, fabric=ShardedPoolCfg(n_shards=3))
    _, info = tt.tiered_sweep(st, cold, rows, tg,
                              fabric=ShardedPoolCfg(n_shards=2))
    assert info["shard_demand_fetches"].shape == (-(-NPPS // tg.chunk), 2)


def test_scatter_hot_last_live_writer_wins():
    """A slot takes its live writer's page, in place; a masked-out entry
    naming the same slot, before or after it, writes nothing."""
    from repro_torch.paging.sharded_pool import scatter_hot
    hot = {"k": torch.zeros((2, 4, 1))}
    leaf = hot["k"]
    data = {"k": torch.arange(1.0, 7.0).reshape(2, 3, 1)}
    dst = torch.tensor([[1, 1, 3], [0, 2, 0]], dtype=torch.int32)
    mask = torch.tensor([[False, True, False], [True, False, False]])
    out = scatter_hot(hot, data, dst, mask)["k"]
    assert out is leaf
    assert out[..., 0].tolist() == [[0.0, 2.0, 0.0, 0.0], [4.0, 0.0, 0.0, 0.0]]


@pytest.mark.parametrize("async_dp", [False, True])
def test_copy_plans_never_name_one_slot_twice(monkeypatch, async_dp):
    """Within one chunk step no two live copies of a stream share a
    destination slot, as the in-place scatter requires."""
    plans = []
    real = tt._apply_copies

    def spy(hot, cold, src, dst, mask, **kw):
        plans.append((dst.clone(), mask.clone()))
        return real(hot, cold, src, dst, mask, **kw)

    monkeypatch.setattr(tt, "_apply_copies", spy)
    cold, rows, _, _ = _inputs(seed=5)
    _, tg = _geoms()
    st = tt.tiered_init(tg, B, torch.float32, CPU)
    tcold = tree_from_numpy(cold, CPU)
    for r in range(4):
        st, _ = tt.tiered_sweep(st, tcold, torch.from_numpy(np.roll(rows, r, 0)),
                                tg, async_datapath=async_dp)
        st = tt.tiered_invalidate(st, torch.from_numpy(rows[:, r:r + 1]))
    assert plans
    for dst, mask in plans:
        for s in range(B):
            live = dst[s][mask[s]].tolist()
            assert len(live) == len(set(live))
