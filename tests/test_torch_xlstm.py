"""Port: the xLSTM mixers against ``repro.models.xlstm``.

mLSTM and sLSTM parameters from the reference's ``mlstm_init`` /
``slstm_init`` (f32), the same inputs from a numpy seed: the prefill
outputs and final carries, then decode steps from those carries (outputs
and carries), and decode from a zeroed carry against prefill. Held at 1e-4
(f32: the reference scans in chunks, the port loops over time, and both
sum their einsums in their own orders). The carries check the
reference's trouble spots: the stabiliser starting at 0, v from the
pre-conv branch, the ``max(|n . q|, 1)`` denominator and sLSTM's ``(4, B,
D) -> (B, 4D)`` gate layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import xlstm as jx  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

TOL = 1e-4
B, S, D, H = 2, 11, 32, 4


def _params(kind, seed):
    key = jax.random.PRNGKey(seed)
    if kind == "mlstm":
        p, _ = jx.mlstm_init(key, D, H, 2.0, 4, jnp.float32)
        # the init leaves conv as an identity tap and the gate biases
        # constant: perturb them so the conv and biases are exercised
        rng = np.random.default_rng(seed)
        p = dict(p, conv=jnp.asarray(rng.standard_normal(p["conv"].shape)
                                     .astype(np.float32) * 0.5),
                 i_bias=jnp.asarray(rng.standard_normal(H).astype(
                     np.float32)),
                 skip=jnp.asarray(rng.standard_normal(p["skip"].shape)
                                  .astype(np.float32)))
    else:
        p, _ = jx.slstm_init(key, D, H, jnp.float32)
    return p, {k: torch.from_numpy(np.asarray(v).copy())
               for k, v in p.items()}


def _x(seed, n=S):
    return np.random.default_rng(seed).standard_normal((B, n, D)).astype(
        np.float32) * 2


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _ref(kind):
    if kind == "mlstm":
        return (lambda p, x: jx.apply_mlstm(p, x, H, 4, True),
                lambda p, x, st: jx.mlstm_decode_step(p, x, st, H))
    return (lambda p, x: jx.apply_slstm(p, x, H, True),
            lambda p, x, st: jx.slstm_decode_step(p, x, st, H))


def _port(kind):
    if kind == "mlstm":
        return (lambda p, x: tx.apply_mlstm(p, x, return_state=True),
                tx.mlstm_decode_step)
    return (lambda p, x: tx.apply_slstm(p, x, return_state=True),
            tx.slstm_decode_step)


def test_shapes_are_the_reference_leaves():
    for kind, shapes in (("mlstm", tx.mlstm_shapes(D, H, 2.0, 4)),
                         ("slstm", tx.slstm_shapes(D, H))):
        jp, _ = _params(kind, 0)
        assert shapes == {k: tuple(v.shape) for k, v in jp.items()}
        for k in tx.F32_LEAVES:
            if k in jp:
                assert jp[k].dtype == jnp.float32


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_output_and_carry_match_jax(kind):
    jp, tp = _params(kind, 1)
    x = _x(2)
    want, wst = _ref(kind)[0](jp, jnp.asarray(x))
    got, gst = _port(kind)[0](tp, torch.from_numpy(x))
    _close(got, want)
    assert wst.keys() == gst.keys()
    for k in wst:
        assert gst[k].shape == wst[k].shape and gst[k].dtype == (
            torch.float32), k
        _close(gst[k], wst[k])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_jax(kind):
    """Four decode steps from the prefill's carry, each output and
    carry against the reference's."""
    jp, tp = _params(kind, 3)
    x = _x(4, S + 4)
    _, wst = _ref(kind)[0](jp, jnp.asarray(x[:, :S]))
    _, gst = _port(kind)[0](tp, torch.from_numpy(x[:, :S]))
    for t in range(S, S + 4):
        want, wst = _ref(kind)[1](jp, jnp.asarray(x[:, t:t + 1]), wst)
        got, gst = _port(kind)[1](tp, torch.from_numpy(x[:, t:t + 1]), gst)
        _close(got, want)
        for k in wst:
            _close(gst[k], wst[k])


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_from_zero_equals_prefill(kind):
    """Decode from the zeroed carry (``m`` 0, not -inf) through the whole
    sequence gives the prefill's outputs and carry."""
    _, tp = _params(kind, 5)
    x = torch.from_numpy(_x(6))
    want, wst = _port(kind)[0](tp, x)
    init = (tx.mlstm_state_init if kind == "mlstm"
            else tx.slstm_state_init)(B, tp)
    assert all(not t.any() for t in init.values())
    st, outs = init, []
    for t in range(S):
        y, st = _port(kind)[1](tp, x[:, t:t + 1], st)
        outs.append(y)
    _close(torch.cat(outs, 1), want)
    for k in wst:
        _close(st[k], wst[k])


def test_slstm_gate_layout_is_the_references():
    """sLSTM's recurrence ``[4, B, H, dh]`` lays out as ``(B, 4D)`` with
    gate g at columns ``g*D .. (g+1)*D``: with only gate z's recurrent
    weights set, only the z part of the pre-activation changes."""
    _, tp = _params("slstm", 7)
    h = torch.randn(B, D, generator=torch.Generator().manual_seed(0))
    zero = torch.zeros(B, D)
    tp0 = dict(tp, r=torch.zeros_like(tp["r"]), bias=torch.zeros(4 * D))
    only_z = dict(tp0, r=torch.cat([tp["r"][:1],
                                    torch.zeros_like(tp["r"][1:])]))
    xw = torch.zeros(B, 4 * D)
    a = tx._slstm_step(tp0, xw, (h, zero, zero, zero))
    b = tx._slstm_step(only_z, xw, (h, zero, zero, zero))
    # z moves the cell (tanh z), i / f / o do not move: n is i's alone
    assert not torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert torch.equal(a[3], b[3])


def test_batch_path_matches_the_reference_cli(tmp_path):
    """``_main_batch`` on the smoke model (the cache-free synthetic K/V
    mirror) against the reference CLI: report integers, event log and
    greedy tokens (``tests/test_torch_family_serving.py``)."""
    from test_torch_family_serving import check_batch_path
    check_batch_path("xlstm_350m", tmp_path)
