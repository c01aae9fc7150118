"""Port: the selective scan and the Mamba mixer against the JAX package.

Inputs are drawn from a seed with numpy and handed to both frameworks. The
scan's plain version is held against the reference's ``selective_scan_ref``
and against its Pallas kernel run in interpret mode, at 2e-5 (f32; the two
sum the N states in different orders). ``apply_mamba`` is held against the
reference with ``REPRO_OPT`` unset (its chunked lax.scan) and set to
``sscan_kernel`` (its kernel route, which the port always takes), and
``mamba_decode_step`` against the reference's step, at 1e-4: the mixer's
projections and conv run in f32 in both, in different summation orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.selective_scan import ops as jops  # noqa: E402
from repro.kernels.selective_scan import ref as jref  # noqa: E402
from repro.models import mamba as jm  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan, selective_scan_ref, selective_scan_state_ref)
from repro_torch.kernels.selective_scan.kernel import \
    selective_scan_launches  # noqa: E402
from repro_torch.models import mamba as tm  # noqa: E402

SCAN_TOL = 2e-5
MIX_TOL = 1e-4


def _scan_inputs(B, S, di, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    b = rng.standard_normal((B, S, N)).astype(np.float32)
    c = rng.standard_normal((B, S, N)).astype(np.float32)
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    a = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    return dt, b, c, x, a


@pytest.mark.parametrize("B,S,di,N", [(2, 24, 16, 8), (1, 64, 32, 16),
                                      (3, 7, 5, 4)])
def test_scan_plain_matches_reference_ref(B, S, di, N):
    ins = _scan_inputs(B, S, di, N, seed=S)
    t = [torch.from_numpy(v) for v in ins]
    j = [jnp.asarray(v) for v in ins]
    np.testing.assert_allclose(selective_scan_ref(*t).numpy(),
                               np.asarray(jref.selective_scan_ref(*j)),
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(selective_scan_state_ref(*t).numpy(),
                               np.asarray(jref.selective_scan_state_ref(*j)),
                               atol=SCAN_TOL, rtol=SCAN_TOL)


def test_scan_plain_matches_the_pallas_kernel_in_interpret_mode():
    ins = _scan_inputs(2, 32, 32, 8, seed=1)
    y, h = jops.selective_scan(*(jnp.asarray(v) for v in ins), block_t=8,
                               block_d=16, interpret=True, return_state=True)
    before = selective_scan_launches.n
    ty, th = selective_scan(*(torch.from_numpy(v) for v in ins),
                            return_state=True)
    assert selective_scan_launches.n == before      # CPU: the plain version
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), atol=SCAN_TOL,
                               rtol=SCAN_TOL)


def _mamba_params(d, expand, N, K, seed):
    """The reference's leaves, drawn with numpy at its scales."""
    di, dt_rank, _ = jm.mamba_dims(d, expand, N)
    rng = np.random.default_rng(seed)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
    lo, hi = np.log(1e-3), np.log(1e-1)
    return {"w_in": w(d, 2 * di), "w_xdbc": w(di, dt_rank + 2 * N),
            "w_dt": w(dt_rank, di), "w_out": w(di, d), "conv": w(K, di),
            "a_log": np.log(np.tile(np.arange(1, N + 1, dtype=np.float32),
                                    (di, 1))),
            "dt_bias": np.log(np.expm1(np.exp(rng.uniform(lo, hi, di))))
            .astype(np.float32),
            "d_skip": (1 + 0.1 * rng.standard_normal(di)).astype(np.float32)}


@pytest.mark.parametrize("kernel_flag", [False, True])
def test_apply_mamba_matches_jax(monkeypatch, kernel_flag):
    d, N = 16, 8
    p = _mamba_params(d, 2, N, 4, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 24, d)).astype(
        np.float32)
    if kernel_flag:
        monkeypatch.setenv("REPRO_OPT", "sscan_kernel")
    else:
        monkeypatch.delenv("REPRO_OPT", raising=False)
    jy, jst = jm.apply_mamba({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), N, return_state=True)
    ty, tst = tm.apply_mamba({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), N, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MIX_TOL,
                               rtol=MIX_TOL)
    for key in ("conv", "h"):
        assert tst[key].dtype == torch.float32
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   atol=MIX_TOL, rtol=MIX_TOL)


def test_mamba_decode_steps_match_jax_and_continue_the_prefill():
    """Three decode steps from the prefill's carry match the reference's,
    and prefill of S + 3 tokens equals prefill of S then 3 steps."""
    d, N = 16, 8
    p = _mamba_params(d, 2, N, 4, seed=5)
    x = np.random.default_rng(6).standard_normal((2, 11, d)).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, jst = jm.apply_mamba(jp, jnp.asarray(x[:, :8]), N, return_state=True)
    _, tst = tm.apply_mamba(tp, torch.from_numpy(x[:, :8]), N,
                            return_state=True)
    full = tm.apply_mamba(tp, torch.from_numpy(x), N)
    for t in range(8, 11):
        jy, jst = jm.mamba_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jst, N)
        ty, tst = tm.mamba_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                       tst, N)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MIX_TOL,
                                   rtol=MIX_TOL)
        np.testing.assert_allclose(ty[:, 0].numpy(), full[:, t].numpy(),
                                   atol=MIX_TOL, rtol=MIX_TOL)
    np.testing.assert_allclose(tst["h"].numpy(), np.asarray(jst["h"]),
                               atol=MIX_TOL, rtol=MIX_TOL)
    zero = tm.mamba_state_init(2, tp, N)
    ref0 = jm.mamba_state_init(2, jp, N)
    for key in ("conv", "h"):
        assert tuple(zero[key].shape) == ref0[key].shape
        assert not zero[key].any()


def test_mamba_dims_and_init_follow_the_reference():
    assert tm.mamba_dims(4096, 2, 16) == jm.mamba_dims(4096, 2, 16)
    shapes = tm.mamba_shapes(64, 2, 8, 4)
    p = {k: torch.empty(s) for k, s in shapes.items()}
    tm.mamba_init_(p, torch.Generator().manual_seed(0))
    assert torch.equal(p["a_log"][3], torch.log(torch.arange(1., 9.)))
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 1e-1 * 1.001
    assert torch.equal(p["d_skip"], torch.ones(128))
