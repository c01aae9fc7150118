"""Port: the Leap controller in PyTorch is bit-exact to the JAX twin and
to the NumPy ``LeapPrefetcher`` (sequential, strided and random streams)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import history as jhist  # noqa: E402
from repro.core import trend as jtrend  # noqa: E402
from repro.core import window as jwin  # noqa: E402
from repro.core.leap_jax import leap_init as j_init  # noqa: E402
from repro.core.leap_jax import leap_step_batched as j_step_b  # noqa: E402
from repro.core.prefetcher import LeapPrefetcher  # noqa: E402
from repro_torch.core import leap as tl  # noqa: E402

CPU = "cpu"


def _streams(kind: str, S: int, T: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "sequential":
        return np.stack([np.arange(T) + 100 * s for s in range(S)])
    if kind == "strided":
        return np.stack([5000 + np.arange(T) * (s - 2) * 3 for s in range(S)])
    if kind == "mixed":   # strided runs broken by random jumps
        out = np.cumsum(rng.choice([1, 1, 1, 2, -7, 40], size=(S, T)), 1)
        return out + 1000
    return rng.integers(0, 1 << 12, size=(S, T))


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("kind", ["sequential", "strided", "mixed", "random"])
def test_batched_state_bit_exact_vs_jax(kind):
    """Every step: the whole state dict, candidates and validity match the
    vmapped JAX controller exactly, with prefetch-hit feedback fed back."""
    S, T = 4, 70
    pages = _streams(kind, S, T, seed=1)
    js, ts = j_init(batch=(S,)), tl.leap_init(batch=(S,), device=CPU)
    out_j = [set() for _ in range(S)]
    for t in range(T):
        hits = np.array([pages[s, t] in out_j[s] for s in range(S)])
        js, jc, jv = j_step_b(js, jnp.asarray(pages[:, t], jnp.int32),
                              jnp.asarray(hits))
        ts, tc, tv = tl.leap_step_batched(
            ts, torch.from_numpy(pages[:, t].astype(np.int32)),
            torch.from_numpy(hits))
        for k in js:
            np.testing.assert_array_equal(_np(js[k]), ts[k].numpy(),
                                          err_msg=f"{kind} t={t} {k}")
        np.testing.assert_array_equal(_np(jc), tc.numpy())
        np.testing.assert_array_equal(_np(jv), tv.numpy())
        for s in range(S):
            out_j[s].discard(int(pages[s, t]))
            out_j[s].update(int(c) for c, v in zip(_np(jc)[s], _np(jv)[s])
                            if v)


@pytest.mark.parametrize("kind", ["sequential", "strided", "mixed", "random"])
def test_unbatched_matches_numpy_prefetcher(kind):
    pages = _streams(kind, 1, 120, seed=2)[0]
    ref = LeapPrefetcher(h_size=32, n_split=8, pw_max=8)
    st = tl.leap_init(device=CPU)
    out_r, out_t = set(), set()
    for p in pages:
        p = int(p)
        hit_r = p in out_r
        out_r.discard(p)
        c_r = ref.on_fault(p, hit_r)
        out_r.update(c_r)
        hit_t = p in out_t
        out_t.discard(p)
        st, cands, valid = tl.leap_step(st, torch.tensor(p, dtype=torch.int32),
                                        torch.tensor(hit_t))
        c_t = [int(c) for c, v in zip(cands, valid) if v]
        out_t.update(c_t)
        assert c_r == c_t


def test_history_and_trend_pieces_match_jax():
    rng = np.random.default_rng(3)
    for n_split in (8, 3, 2):
        jst, tst = jhist.init_history(32), tl.init_history(32, device=CPU)
        for _ in range(45):
            page = int(rng.choice([rng.integers(0, 50), 7]))
            jst, jd = jhist.push_history(jst, jnp.int32(page))
            tst, td = tl.push_history(tst, torch.tensor(page,
                                                        dtype=torch.int32))
            assert int(jd) == int(td)
            jv, jm = jhist.history_window_gather(jst)
            tv, tm = tl.history_window_gather(tst)
            np.testing.assert_array_equal(_np(jv), tv.numpy())
            np.testing.assert_array_equal(_np(jm), tm.numpy())
            jt, jf = jtrend.find_trend_jax(jst, n_split=n_split)
            tt, tf = tl.find_trend(tst, n_split=n_split)
            assert (int(jt), bool(jf)) == (int(tt), bool(tf))
            jc, jf2 = jtrend._masked_boyer_moore(jv, jm)
            tc, tf2 = tl._masked_boyer_moore(tv, tm)
            assert (int(jc), bool(jf2)) == (int(tc), bool(tf2))


def test_window_pieces_match_jax():
    x = np.concatenate([np.arange(1, 2000), 2 ** np.arange(1, 20),
                        2 ** np.arange(1, 20) + 1]).astype(np.int32)
    got = tl._round_up_pow2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _np(jwin._round_up_pow2_jax(x)))
    assert all(int(g) == jwin.round_up_pow2(int(v)) for g, v in zip(got, x))
    rng = np.random.default_rng(4)
    c_hit = rng.integers(0, 12, 64).astype(np.int32)
    pw_prev = rng.integers(0, 9, 64).astype(np.int32)
    follows = rng.random(64) < 0.5
    jst = {"c_hit": jnp.asarray(c_hit), "pw_prev": jnp.asarray(pw_prev)}
    tst = {"c_hit": torch.from_numpy(c_hit),
           "pw_prev": torch.from_numpy(pw_prev)}
    js2, jpw = jwin.next_window_size(jst, jnp.asarray(follows))
    ts2, tpw = tl.next_window_size(tst, torch.from_numpy(follows))
    np.testing.assert_array_equal(_np(jpw), tpw.numpy())
    hits = rng.integers(0, 3, 64).astype(np.int32)
    jn = jwin.note_prefetch_hits(js2, jnp.asarray(hits))
    tn = tl.note_prefetch_hits(ts2, torch.from_numpy(hits))
    for k in jn:
        np.testing.assert_array_equal(_np(jn[k]), tn[k].numpy())


@pytest.mark.parametrize("n_split", [8, 3, 1])
def test_trend_ladder_matches_jax_vote_on_random_windows(n_split):
    """The counting ladder gives the reference vote's (delta, found) on
    windows with and without majorities, full and partly valid."""
    rng = np.random.default_rng(7 + n_split)
    B, H = 400, 32
    vals = rng.integers(-2, 3, (B, H)).astype(np.int32)
    vals[: B // 2, : H // 2] = 1                      # plenty of majorities
    count = rng.integers(0, H + 1, B)
    valid = np.arange(H)[None, :] < count[:, None]
    jd, jf = jax.vmap(lambda v, m: jtrend.trend_ladder(v, m, n_split))(
        jnp.asarray(vals), jnp.asarray(valid))
    td, tf = tl.trend_ladder(torch.from_numpy(vals), torch.from_numpy(valid),
                             n_split)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert tf.any() and not tf.all()


@pytest.mark.parametrize("n_split", [8, 3, 1])
def test_trend_ladder_matches_port_vote_rung_by_rung(n_split):
    """The counting ladder equals the ladder run with the port's own
    sequential vote: the first rung whose vote verifies wins."""
    rng = np.random.default_rng(11 + n_split)
    B, H = 300, 32
    vals = rng.integers(-1, 2, (B, H)).astype(np.int32)
    vals[: B // 3, : H // 4] = 2
    valid = np.arange(H)[None, :] < rng.integers(0, H + 1, B)[:, None]
    tv, tm = torch.from_numpy(vals), torch.from_numpy(valid)
    want_d = torch.zeros(B, dtype=torch.int32)
    want_f = torch.zeros(B, dtype=torch.bool)
    for w in tl._rung_widths(H, n_split):
        cand, found = tl._masked_boyer_moore(
            tv, tm & (torch.arange(H) < w)[None, :])
        take = found & ~want_f
        want_d = torch.where(take, cand, want_d)
        want_f |= found
    td, tf = tl.trend_ladder(tv, tm, n_split)
    assert torch.equal(tf, want_f) and torch.equal(td, want_d)
    assert tf.any() and not tf.all()
