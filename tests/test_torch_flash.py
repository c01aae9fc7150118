"""Port: GQA prefill attention against ``repro.kernels.flash_attention``.

The port's plain version (what the CPU runs, and what the CUDA kernel is
held against on the card) against the reference's ``flash_attention_ref``
in the kernel layout, and against its Pallas kernel in interpret mode in
the model layout, over causal, sliding-window and ``q_offset`` masks, GQA
and MHA, head dims 160, 64 and 16, and Sq != Sk. Inputs from a numpy
seed; tolerance 2e-5 (f32, the reference's kernel-vs-oracle bound). And
the route rule (``tensor_core_route``) on CPU tensors, which it reads
only for dtype, head dim, base alignment and strides.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_attention as jflash  # noqa
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jref  # noqa: E402
from repro.models.attention import full_attention  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_launches, tensor_core_route)
from repro_torch.models.attention import blocked_attention  # noqa: E402

TOL = 2e-5

CASES = [  # B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset
    (2, 16, 16, 4, 2, 64, True, 0, 0),
    (1, 24, 24, 4, 4, 16, True, 5, 0),
    (2, 8, 40, 6, 2, 16, True, 0, 32),
    (1, 8, 40, 4, 1, 64, True, 12, 32),
    (2, 12, 20, 4, 2, 16, False, 0, 0),
    (1, 16, 16, 2, 1, 16, False, 6, 0),
    (1, 12, 20, 8, 2, 160, True, 0, 8),     # stablelm-12b's dh 160, GQA 4
]


def _inputs(B, Sq, Sk, Hq, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, dh)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window,q_offset", CASES)
def test_plain_matches_reference_ref(B, Sq, Sk, Hq, Hkv, dh, causal, window,
                                     q_offset):
    q, k, v = (x.transpose(0, 2, 1, 3) for x in
               _inputs(B, Sq, Sk, Hq, Hkv, dh, seed=Sq + Sk))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[3]])
def test_model_layout_matches_the_pallas_kernel_in_interpret_mode(case):
    B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset = case
    q, k, v = _inputs(B, Sq, Sk, Hq, Hkv, dh, seed=1)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  block_q=8, block_k=8, interpret=True, **kw)
    before = flash_attention_launches.n
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **kw)
    assert flash_attention_launches.n == before     # CPU: the plain version
    assert got.shape == (B, Sq, Hq, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_causal_attention_is_the_reference_full_attention():
    """The model's prefill attention against ``full_attention``."""
    q, k, v = _inputs(2, 9, 9, 4, 2, 16, seed=3)
    want = full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("Sq,Sk", [(9, 9), (7, 20), (21, 6)])
def test_unmasked_attention_is_the_reference_full_attention(Sq, Sk):
    """The encoder's and the prefill cross-attention's unmasked attention
    (``Sq`` and ``Sk`` free) against ``full_attention(causal=False)``,
    which the reference's encoder-decoder calls for the cross-attention."""
    q, k, v = _inputs(2, Sq, Sk, 4, 2, 16, seed=Sq * Sk)
    want = full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False)
    got = blocked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_fully_masked_rows_are_zero():
    q, k, v = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy()) for x in
               _inputs(1, 4, 8, 2, 1, 16, seed=4))
    o = flash_attention_ref(q, k, v, causal=True, q_offset=-2)
    assert not o[:, :, :2].any() and o[:, :, 2:].abs().sum() > 0


def _bhsd(dh, dtype=torch.bfloat16, pad=0, offset=0):
    """q [1, 4, 8, dh] and k / v [1, 2, 8, dh] as views of buffers whose
    rows are ``dh + pad`` wide, starting ``offset`` elements in."""
    def view(h):
        buf = torch.zeros(offset + h * 8 * (dh + pad), dtype=dtype)
        return buf[offset:].view(1, h, 8, dh + pad)[..., :dh]
    return view(4), view(2), view(2)


@pytest.mark.parametrize("dh", [64, 80, 128, 136, 160])
def test_tensor_core_route_takes_bf16_up_to_dh_160(dh):
    assert tensor_core_route(*_bhsd(dh))


@pytest.mark.parametrize("dh", [161, 192, 256])
def test_tensor_core_route_leaves_bf16_past_dh_160(dh):
    assert not tensor_core_route(*_bhsd(dh))


def test_tensor_core_route_leaves_float32():
    assert not tensor_core_route(*_bhsd(160, dtype=torch.float32))


@pytest.mark.parametrize("pad,offset", [(4, 0), (0, 4)])
def test_tensor_core_route_leaves_views_no_tensor_map_takes(pad, offset):
    """Rows 164 elements apart (328 bytes, not whole 16-byte units), or a
    base 8 bytes off a 16-byte boundary."""
    q, k, v = _bhsd(160, pad=pad, offset=offset)
    assert q.data_ptr() % 16 or q.stride(2) % 8
    assert not tensor_core_route(q, k, v)
