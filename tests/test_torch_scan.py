"""Port: the selective-scan kernel's host rules, and the scan on the inputs
the Mamba mixer hands it, on the CPU.

The CUDA kernel takes its inputs as the model holds them (float32 ``dt``,
``x`` in float32 or bfloat16, ``b`` / ``c`` strided views of one
projection) and picks its copy route (TMA or ``cp.async``) by a host rule
of the shapes, dtypes, strides and alignment alone. The rule, and which
views the kernel takes, are pure functions and are tested here; the kernel itself is held
bitwise against the plain version on the card (``test_torch_cuda.py``).
The plain version, on those same inputs, is held against the JAX
reference's ``selective_scan_ref`` and its Pallas kernel in interpret mode
at 2e-5 (``test_torch_mamba.py``'s ``SCAN_TOL``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.selective_scan import ops as jops  # noqa: E402
from repro.kernels.selective_scan import ref as jref  # noqa: E402
from repro_torch.kernels.selective_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.selective_scan import ops as so  # noqa: E402
from repro_torch.kernels.selective_scan import selective_scan  # noqa: E402

SCAN_TOL = 2e-5


def _model_inputs(B, S, di, N, R, xdtype, seed):
    """The mixer's scan inputs: f32 dt, x in ``xdtype``, b and c views of
    one [B, S, R + 2N] projection, a [di, N]; drawn with numpy."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 2)).astype(
        np.float32)
    x = torch.from_numpy(rng.standard_normal((B, S, di)).astype(
        np.float32)).to(xdtype)
    dbc = torch.from_numpy(rng.standard_normal((B, S, R + 2 * N)).astype(
        np.float32))
    a = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    return (torch.from_numpy(dt), dbc[..., R:R + N], dbc[..., R + N:], x,
            torch.from_numpy(a))


# ---- the route -------------------------------------------------------------

def _aligned(shape, dtype=torch.float32, offset=0):
    """A contiguous tensor whose base lies ``offset`` elements past a
    64-byte boundary."""
    n = int(np.prod(shape))
    buf = torch.zeros(n + offset + 64, dtype=dtype)
    start = (-buf.data_ptr()) % 64 // buf.element_size()
    return buf[start + offset:start + offset + n].view(shape)


@pytest.mark.parametrize("B,S,di,N,R,xdtype,tma", [
    (4, 1024, 8192, 16, 256, torch.bfloat16, True),   # jamba's bf16 prefill
    (2, 68, 8192, 16, 256, torch.float32, True),      # its f32 check
    (1, 1, 64, 16, 32, torch.bfloat16, True),         # S = 1
    (2, 37, 40, 4, 4, torch.float32, True),           # rows of 48 bytes
    (2, 37, 40, 8, 3, torch.bfloat16, False),         # rows of 76 bytes
    (2, 37, 5, 16, 1, torch.bfloat16, False),         # di 5, b 4 B off
    (2, 37, 12, 16, 4, torch.bfloat16, False),        # x rows of 24 bytes
    (2, 37, 64, 2, 4, torch.float32, False),          # N 2: rows of 8 B
    (2, 0, 64, 16, 4, torch.float32, False),          # no time step
])
def test_tma_route_of_the_models_views(B, S, di, N, R, xdtype, tma):
    dt = _aligned((B, S, di))
    x = _aligned((B, S, di), xdtype)
    dbc = _aligned((B, S, R + 2 * N))
    b, c = dbc[..., R:R + N], dbc[..., R + N:]
    a = _aligned((di, N))
    sk.check_inputs(dt, b, c, x, a)
    assert sk.tma_route(dt, b, c, x) is tma


def test_tma_route_needs_aligned_bases_and_strides():
    dt, x = _aligned((2, 9, 64)), _aligned((2, 9, 64))
    b, c = _aligned((2, 9, 16)), _aligned((2, 9, 16))
    assert sk.tma_route(dt, b, c, x)
    # a base 4 bytes past a 16-byte boundary
    assert not sk.tma_route(_aligned((2, 9, 64), offset=1), b, c, x)
    # a row stride of 68 floats (272 B) is whole 16-byte units; 66 is not
    wide = _aligned((2, 9, 68))[..., :64]
    assert sk.tma_route(wide, b, c, x)
    assert not sk.tma_route(_aligned((2, 9, 66))[..., :64], b, c, x)
    # a sequence stride that overlaps the rows inside it (b expanded over B)
    flat = _aligned((1, 9, 16)).expand(2, 9, 16)
    assert not sk.tma_route(dt, flat, c, x)
    # one sequence of one row: no stride to describe, even at 20 bytes
    one = _aligned((1, 1, 5))
    assert sk.tma_route(one, _aligned((1, 1, 4)), _aligned((1, 1, 4)), one)


# ---- which views the kernel takes ------------------------------------------

def _good():
    return (_aligned((2, 9, 32)), _aligned((2, 9, 8)), _aligned((2, 9, 8)),
            _aligned((2, 9, 32), torch.bfloat16), _aligned((32, 8)))


@pytest.mark.parametrize("bad", [
    "x_float16", "x_float64", "dt_bfloat16", "b_bfloat16", "a_bfloat16",
    "x_inner_stride", "b_inner_stride", "a_transposed", "n_3", "n_128",
    "x_shape", "c_shape", "a_shape", "dt_2d"])
def test_check_inputs_raises_on_views_it_does_not_take(bad):
    dt, b, c, x, a = _good()
    sk.check_inputs(dt, b, c, x, a)                    # the baseline passes
    if bad == "x_float16":
        x = x.half()
    elif bad == "x_float64":
        x = x.double()
    elif bad == "dt_bfloat16":
        dt = dt.bfloat16()
    elif bad == "b_bfloat16":
        b = b.bfloat16()
    elif bad == "a_bfloat16":
        a = a.bfloat16()
    elif bad == "x_inner_stride":
        x = _aligned((2, 9, 64), torch.bfloat16)[..., ::2]
    elif bad == "b_inner_stride":
        b = _aligned((2, 9, 16))[..., ::2]
    elif bad == "a_transposed":
        a = _aligned((8, 32)).t()
    elif bad in ("n_3", "n_128"):
        n = int(bad[2:])
        b, c, a = _aligned((2, 9, n)), _aligned((2, 9, n)), _aligned((32, n))
    elif bad == "x_shape":
        x = _aligned((2, 9, 31), torch.bfloat16)
    elif bad == "c_shape":
        c = _aligned((2, 8, 8))
    elif bad == "a_shape":
        a = _aligned((31, 8))
    elif bad == "dt_2d":
        dt = dt[0]
    with pytest.raises(ValueError):
        sk.check_inputs(dt, b, c, x, a)


def test_kernel_views_take_the_models_tensors_as_they_are():
    """The mixer's own inputs pass through without a copy; any other dtype
    is cast to f32, and a view without a unit inner stride copied, in ops;
    the result is always a set the kernel takes."""
    dt, b, c, x, a = _model_inputs(2, 9, 32, 8, 3, torch.bfloat16, seed=0)
    views = so._kernel_views(dt, b, c, x, a)
    assert all(v is t for v, t in zip(views, (dt, b, c, x, a)))
    sk.check_inputs(*views)
    odd = (dt.half(), b.double(), c, x.half(), a.t().contiguous().t())
    views = so._kernel_views(*odd)
    sk.check_inputs(*views)
    assert [v.dtype for v in views] == [torch.float32] * 5
    strided = _aligned((2, 9, 64), torch.bfloat16)[..., ::2]
    views = so._kernel_views(dt, b, c, strided, a)
    assert views[3].dtype == torch.bfloat16 and views[3].is_contiguous()
    assert torch.equal(views[3], strided)


# ---- the scan on the model's inputs, against the JAX package ----------------

@pytest.mark.parametrize("B,S,di,N,R", [(2, 24, 16, 8, 3), (1, 32, 40, 16, 8),
                                        (3, 8, 5, 4, 1)])
def test_scan_on_bf16_x_and_strided_bc_matches_jax(B, S, di, N, R):
    """ops.selective_scan on the CPU with bf16 x and b / c strided views
    against the reference's selective_scan_ref and its Pallas kernel in
    interpret mode (handed the same bf16 x), and against itself on f32
    contiguous copies (bitwise: the bf16 -> f32 conversion is exact)."""
    dt, b, c, x, a = _model_inputs(B, S, di, N, R, torch.bfloat16, seed=S)
    before = sk.selective_scan_launches.n
    y, h = selective_scan(dt, b, c, x, a, return_state=True)
    assert sk.selective_scan_launches.n == before   # CPU: the plain version
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    y32, h32 = selective_scan(dt, b.contiguous(), c.contiguous(), x.float(),
                              a, return_state=True)
    assert torch.equal(y, y32) and torch.equal(h, h32)

    j = [jnp.asarray(t.float().numpy()) for t in (dt, b, c)]
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ja = jnp.asarray(a.numpy())
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jref.selective_scan_ref(*j, jx, ja)),
        atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(
        h.numpy(), np.asarray(jref.selective_scan_state_ref(*j, jx, ja)),
        atol=SCAN_TOL, rtol=SCAN_TOL)
    py, ph = jops.selective_scan(*j, jx, ja, block_t=8, block_d=8,
                                 interpret=True, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(ph), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
