"""Port: the MoE feed-forward against ``repro.models.moe``.

The integer routing must match exactly: the router's expert ids (ties
included: the lower id first, as ``lax.top_k``), and per group the stable
expert sort, the capacity slot of each assignment and the drop mask, which
the reference computes inside ``_dispatch_group`` (its lines are repeated
here in jnp as the oracle). Outputs and the aux loss are held at 1e-5
(f32; the einsums sum in different orders), with and without drops, with
and without the shared expert; so is the per-token oracle
``apply_moe_dense_ref``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = 1e-5


def _params(d, F, E, seed):
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    return {"wr": w(d, E), "wg": w(E, d, F), "wu": w(E, d, F),
            "wd": w(E, F, d)}


def _reference_plan(ids_group, E, C):
    """``_dispatch_group``'s integer lines, on one group's ids [T, k]."""
    e_flat = ids_group.reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    es = e_flat[order]
    N = es.shape[0]
    oh = (es[:, None] == jnp.arange(E)[None, :]).astype(jnp.int32)
    rank = (jnp.cumsum(oh, 0) - oh)[jnp.arange(N), es]
    keep = rank < C
    dest = jnp.where(keep, es * C + rank, E * C)
    return [np.asarray(a) for a in (order, rank, keep, dest)]


@pytest.mark.parametrize("cf,dropless", [(1.0, False), (0.5, False),
                                         (1.25, True)])
def test_routing_is_exact_and_outputs_match(cf, dropless):
    B, S, d, F, E, k = 3, 10, 16, 24, 4, 2
    p = _params(d, F, E, seed=int(cf * 8) + dropless)
    x = np.random.default_rng(7).standard_normal((B, S, d)).astype(np.float32)
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    jw, jids, jaux = jmoe._router(jnp.asarray(x.reshape(B * S, d)), jp["wr"],
                                  k)
    tw, tids, taux = tmoe.router(torch.from_numpy(x.reshape(B * S, d)),
                                 tp["wr"], k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=TOL)
    C = tmoe.capacity(S, k, E, cf, dropless)
    assert C == (S if dropless else max(1, int(-(-S * k // E) * cf)))
    plan = tmoe.dispatch_plan(tids.reshape(B, S, k), E, C)
    drops = 0
    for g in range(B):
        want = _reference_plan(jnp.asarray(jids).reshape(B, S, k)[g], E, C)
        for got, ref in zip(plan, want):
            np.testing.assert_array_equal(got[g].numpy(), ref)
        drops += int((~want[2]).sum())
    if dropless:
        assert drops == 0
    if cf == 0.5:
        assert drops > 0                     # the small capacity does drop
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), k, cf, dropless=dropless)
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), k, cf,
                              dropless=dropless)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=TOL)


def test_ties_pick_the_lower_expert_first():
    """Two router columns equal: every token sees a tie; ``lax.top_k``
    and the port both rank the lower expert id first."""
    d, E = 8, 6
    rng = np.random.default_rng(1)
    wr = rng.standard_normal((d, E)).astype(np.float32)
    wr[:, 4] = wr[:, 1]
    wr[:, 5] = wr[:, 2]
    x = rng.standard_normal((20, d)).astype(np.float32)
    _, jids, _ = jmoe._router(jnp.asarray(x), jnp.asarray(wr), 3)
    _, tids, _ = tmoe.router(torch.from_numpy(x), torch.from_numpy(wr), 3)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))


def test_decode_group_of_one_token_routes_as_prefill():
    """Dropless (the inference setting): a token routed alone gives the
    output it gets inside its prefill group, as in the reference."""
    B, S, d, F, E, k = 2, 6, 16, 24, 4, 2
    p = {n: torch.from_numpy(v) for n, v in _params(d, F, E, 9).items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, S, d)).astype(np.float32))
    full, _ = tmoe.apply_moe(p, x, k, dropless=True)
    one, _ = tmoe.apply_moe(p, x[:, 4:5], k, dropless=True)
    np.testing.assert_allclose(one[:, 0].numpy(), full[:, 4].numpy(),
                               atol=TOL)


def _shared_params(d, F, E, n_shared, seed):
    p = _params(d, F, E, seed)
    if n_shared:
        rng = np.random.default_rng(seed + 100)
        w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(
            np.float32)
        p["shared"] = {"wg": w(d, F * n_shared), "wu": w(d, F * n_shared),
                       "wd": w(F * n_shared, d)}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("k", [1, 2])
def test_shared_expert_and_dense_oracle_match_jax(n_shared, k):
    """With and without the shared expert, top-1 and top-2: the routing
    ids exact; ``apply_moe`` (dropless and with drops) and the per-token
    oracle ``apply_moe_dense_ref`` within 1e-5 of the reference's; and,
    dropless, the dispatch equal to the oracle."""
    B, S, d, F, E = 2, 9, 16, 24, 4
    p = _shared_params(d, F, E, n_shared, seed=10 * n_shared + k)
    x = np.random.default_rng(k).standard_normal((B, S, d)).astype(
        np.float32)
    jp, tp = _tree(p, jnp.asarray), _tree(p, torch.from_numpy)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _, jids, _ = jmoe._router(jx.reshape(B * S, d), jp["wr"], k)
    _, tids, _ = tmoe.router(tx.reshape(B * S, d), tp["wr"], k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    want = jmoe.apply_moe_dense_ref(jp, jx, k)
    got = tmoe.apply_moe_dense_ref(tp, tx, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    for cf, dropless in ((1.25, True), (0.5, False)):
        jy, _ = jmoe.apply_moe(jp, jx, k, cf, dropless=dropless)
        ty, _ = tmoe.apply_moe(tp, tx, k, cf, dropless=dropless)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL,
                                   rtol=TOL)
        if dropless:
            np.testing.assert_allclose(ty.numpy(), got.numpy(), atol=TOL,
                                       rtol=TOL)
    if n_shared:                  # the shared branch is really taken
        bare = {n: v for n, v in tp.items() if n != "shared"}
        assert not torch.allclose(tmoe.apply_moe_dense_ref(bare, tx, k), got)


def test_gelu_moe_still_raises_naming_the_roadmap():
    """A GELU MoE (GeGLU experts, tanh GELU as ``jax.nn.gelu``'s
    default) and its per-token oracle match the reference's, with and
    without drops. (The id is kept from when a GELU MoE raised.)"""
    p = _params(8, 12, 4, 0)
    x = np.random.default_rng(1).standard_normal((2, 6, 8)).astype(
        np.float32)
    jp = {n: jnp.asarray(v) for n, v in p.items()}
    tp = {n: torch.from_numpy(v) for n, v in p.items()}
    for cf, dropless in ((1.0, False), (1.25, True)):
        want, waux = jmoe.apply_moe(jp, jnp.asarray(x), 2, cf, act="gelu",
                                    dropless=dropless)
        got, gaux = tmoe.apply_moe(tp, torch.from_numpy(x), 2, cf,
                                   act="gelu", dropless=dropless)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
        np.testing.assert_allclose(float(gaux), float(waux), atol=TOL)
    oracle = tmoe.apply_moe_dense_ref(tp, torch.from_numpy(x), 2, act="gelu")
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), atol=TOL)
