"""Port: ``ExpertPrefetcher`` (MoE expert paging) against the reference's.

Five routing traces over 16 experts, each on the sync path, the async path
and the async path under a one-block link budget:

* the reference tests' three (``tests/test_paging.py::TestExpertPaging``):
  a cyclic route, a uniform-random one (``jax.random`` key 0) and the two
  streams of its budgeted test (cycles of 4 and of 8);
* a Zipf-skewed route, two streams;
* a model-routed one: the top-2 ids the phi3.5-moe smoke model's first
  MoE layer gives a prompt, one stream per choice slot (the (layer, slot)
  streams), captured with a forward pre-hook on that layer, as
  ``chip_smoke.py`` captures them at full width.

``consume_route_traces`` must give the reference's checksums, ``info``
columns and per-stream ``stream_stats`` exactly; ``fetch``, step by step,
and ``consume_route_trace`` (every stream at once here; against the
reference's one-stream scan, vmapped) the same ``hit`` / ``pref_hit`` / ``partial_hit``
columns and stats, each served block the slow tier's row, bitwise. The blocks
hold integers (exact in float32), so checksums compare exactly. The
two-stream traces share the budgeted test's length, 120 steps, so the
reference compiles each data path once for them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.paging import prefetch_serving as jps  # noqa: E402
from repro.paging.expert_stream import ExpertPrefetcher as JEP  # noqa: E402
from repro_torch.paging import ExpertPrefetcher  # noqa: E402
from repro_torch.paging import prefetch_serving as tps  # noqa: E402

CPU = "cpu"
E, BLOCK = 16, 8
WEIGHTS = np.arange(E * BLOCK, dtype=np.float32).reshape(E, BLOCK)
PATHS = {"sync": dict(async_datapath=False),
         "async": dict(async_datapath=True),
         "budget1": dict(async_datapath=True, link_budget=1)}


def _model_trace(T: int = 120) -> np.ndarray:
    """``[2, T]``: the phi3.5-moe smoke model's layer-0 top-2 ids for one
    prompt's first T tokens, slot-major."""
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models.moe import router
    cfg = configs.get_smoke_config("phi35_moe_42b")
    model = build_model(cfg, device=CPU, seed=0)
    seen = []
    moe = model.blocks[0].ff
    hook = moe.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0][0, :T].clone()))
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (1, T)))
    model.prefill(toks, T)
    hook.remove()
    _, ids, _ = router(seen[0], moe.wr, cfg.top_k)
    return ids.t().numpy().astype(np.int32)


def _zipf_trace(T: int = 120) -> np.ndarray:
    rng = np.random.default_rng(11)
    perm = rng.permutation(E)
    return perm[np.minimum(rng.zipf(1.4, (2, T)) - 1, E - 1)].astype(np.int32)


TRACES = {
    "cyclic": lambda: np.tile(np.arange(4), 40)[None].astype(np.int32),
    "uniform": lambda: np.asarray(jax.random.randint(
        jax.random.PRNGKey(0), (160,), 0, 16))[None].astype(np.int32),
    "two_cycles": lambda: np.stack([np.tile(np.arange(4), 30),
                                    np.tile(np.arange(8), 15)]
                                   ).astype(np.int32),
    "zipf": _zipf_trace,
    "model": _model_trace,
}


def _eps(path, n_hot=6):
    kw = PATHS[path]
    return (JEP(n_experts=E, n_hot=n_hot, block_elems=BLOCK, **kw),
            ExpertPrefetcher(n_experts=E, n_hot=n_hot, block_elems=BLOCK,
                             **kw))


def _stats_equal(jst, tst, n):
    for i in range(n):
        assert tps.stream_stats_at(tst, i) == jps.stream_stats_at(jst, i), i


@functools.lru_cache(maxsize=None)
def _reference_traces(trace, path):
    """The reference's ``consume_route_traces`` of a trace on a path (run
    once for this file: the fetch test reads it again)."""
    jep, _ = _eps(path)
    return jep.consume_route_traces(jnp.asarray(WEIGHTS),
                                    jnp.asarray(TRACES[trace]()))


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("trace", list(TRACES))
def test_consume_route_traces_matches_the_reference(trace, path):
    ids = TRACES[trace]()
    _, tep = _eps(path)
    jst, jsums, jinfo = _reference_traces(trace, path)
    tst, tsums, tinfo = tep.consume_route_traces(torch.from_numpy(WEIGHTS),
                                                 torch.from_numpy(ids))
    np.testing.assert_array_equal(tsums.numpy(), np.asarray(jsums))
    np.testing.assert_array_equal(tsums.numpy(), WEIGHTS[ids].sum(-1))
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        np.testing.assert_array_equal(tinfo[k].numpy(), np.asarray(jinfo[k]),
                                      err_msg=k)
    _stats_equal(jst, tst, ids.shape[0])
    if path == "budget1" and trace == "two_cycles":   # the reference's test
        assert int(tinfo["deferred"].sum()) > 0


def _reference_scan(jep, ids):
    """The reference's one-stream ``consume_route_trace``, vmapped over the
    streams of ``ids [S, T]``."""
    init = jax.tree.map(lambda x: jnp.stack([x] * ids.shape[0]), jep.init())
    return jax.vmap(lambda st, i: jep.consume_route_trace(
        st, jnp.asarray(WEIGHTS), i))(init, jnp.asarray(ids))


@pytest.mark.parametrize("path", ["sync", "async"])
@pytest.mark.parametrize("trace", list(TRACES))
def test_fetch_serves_blocks_and_matches_the_reference_scan(trace, path):
    """``fetch`` step by step, every stream at once: each served block is
    the slow tier's row, bitwise, and the ``hit`` / ``pref_hit`` /
    ``partial_hit`` columns and the stats are the reference's (its
    unbudgeted ``consume_route_traces``, whose streams are independent)."""
    ids = TRACES[trace]()
    _, tep = _eps(path)
    jst, _, jinfo = _reference_traces(trace, path)
    st = tep.init(device=CPU, n_streams=ids.shape[0])
    w = torch.from_numpy(WEIGHTS)
    for t in range(ids.shape[1]):
        e = torch.from_numpy(ids[:, t])
        st, block, info = tep.fetch(st, w, e)
        assert torch.equal(block, w[e.long()]), t
        for k in ("hit", "pref_hit", "partial_hit"):
            np.testing.assert_array_equal(info[k].numpy(),
                                          np.asarray(jinfo[k])[:, t],
                                          err_msg=f"{k} at step {t}")
    _stats_equal(jst, st, ids.shape[0])
    if trace == "cyclic":                  # the reference tests' claims
        assert tps.stream_stats_at(st, 0)["prefetch_hits"] > 50
    if trace == "uniform" and path == "sync":
        assert tps.stream_stats_at(st, 0)["prefetch_issued"] < 30


@pytest.mark.parametrize("trace", ["cyclic", "model"])
def test_consume_route_trace_matches_the_reference(trace):
    """The scan over a ``[T]`` trace (a one-stream state) and over ``[S,
    T]``: the reference's columns, in ``ids``' shape, and stats."""
    ids = TRACES[trace]()
    jep, tep = _eps("async")
    jst, jinfo = _reference_scan(jep, ids)
    one = ids.shape[0] == 1
    tst, tinfo = tep.consume_route_trace(
        tep.init(device=CPU, n_streams=ids.shape[0]),
        torch.from_numpy(WEIGHTS), torch.from_numpy(ids[0] if one else ids))
    for k in ("hit", "pref_hit", "partial_hit"):
        want = np.asarray(jinfo[k])
        np.testing.assert_array_equal(tinfo[k].numpy(),
                                      want[0] if one else want, err_msg=k)
    _stats_equal(jst, tst, ids.shape[0])
    assert tep.geom().n_slots == 6 and tep.geom().pw_max == 2
