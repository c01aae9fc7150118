"""Port: GQA prefill attention against ``repro.kernels.flash_attention``.

The port's plain version (what the CPU runs, and what the CUDA kernel is
held against on the card) against the reference's ``flash_attention_ref``
in the kernel layout, and against its Pallas kernel in interpret mode in
the model layout, over causal, sliding-window and ``q_offset`` masks, GQA
and MHA, head dims 256, 192, 160, 64 and 16, and Sq != Sk. Inputs from a
numpy seed; tolerance 2e-5 (f32, the reference's kernel-vs-oracle bound).
And the route rule (``route``, ``tensor_core_route``, ``tile_width``,
``packed``) on CPU tensors, which it reads only for dtype, head dim, base
alignment and strides: every bf16 input takes ``wgmma`` (views no tensor
map takes packed first), every f32 input the split route. And the passes
that feed the kernel on the CPU: the plain split (``split_bf16x3_ref``)
sums back to x bitwise, the plain pack (``pack_bf16_ref``) is x bitwise,
zero past ``dh``, and an emulation of the split route's six part products
(bf16 parts, float32 matmuls, the instantiation's key tiles, the online
softmax, P in three parts) holds the reference to 2e-5 at every case.
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
    flash_attention_launches, packed, route, tensor_core_route, tile_width)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    pack_bf16_ref, split_bf16x3_ref)
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
    (1, 12, 40, 8, 2, 192, True, 16, 20),   # dh 192, GQA 4, window + offset
    (2, 10, 24, 4, 1, 256, True, 0, 14),    # dh 256, GQA 4, offset
    (1, 20, 70, 8, 2, 160, True, 0, 50),    # dh 160, split DHP 192
    (1, 24, 40, 4, 1, 160, True, 0, -8),    # rows 0-7 fully masked
    (2, 16, 50, 4, 2, 256, True, 20, 40),   # dh 256, window + offset
    (1, 12, 30, 4, 1, 256, True, 8, 40),    # a window past Sk: all masked
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
    """Past dh 160 bf16 stays on ``wgmma`` up to 256: dh 161 and 192 on
    the DHP-192 instantiation, 256 on DHP 256, on rows padded to whole
    16-byte units. A dh-161 row packed tight (322 bytes) is a view no
    tensor map takes: it stays on ``wgmma`` too, its q, k and v packed
    first."""
    q, k, v = _bhsd(dh, pad=-dh % 8)
    assert route(q, k, v) == "wgmma" and tensor_core_route(q, k, v)
    assert tile_width("wgmma", dh) == {161: 192, 192: 192, 256: 256}[dh]
    tight = _bhsd(dh)
    assert route(*tight) == "wgmma" and packed(*tight) == (dh % 8 > 0,) * 3


def test_tensor_core_route_leaves_float32():
    """f32 at stablelm's dh 160 runs on the tensor cores too: the split
    route's DHP-192 instantiation."""
    q, k, v = _bhsd(160, dtype=torch.float32)
    assert route(q, k, v) == "split_f32" and tensor_core_route(q, k, v)
    assert tile_width("split_f32", 160) == 192


@pytest.mark.parametrize("pad,offset", [(4, 0), (0, 4)])
def test_tensor_core_route_leaves_views_no_tensor_map_takes(pad, offset):
    """Rows 164 elements apart (328 bytes, not whole 16-byte units), or a
    base 8 bytes off a 16-byte boundary: still ``wgmma``, at DHP 160, with
    q, k and v packed first."""
    q, k, v = _bhsd(160, pad=pad, offset=offset)
    assert q.data_ptr() % 16 or q.stride(2) % 8
    assert route(q, k, v) == "wgmma" and tensor_core_route(q, k, v)
    assert tile_width("wgmma", 160) == 160
    assert packed(q, k, v) == (True, True, True)


@pytest.mark.parametrize("dh,dhp", [(16, 64), (64, 64), (80, 128),
                                    (120, 128), (128, 128)])
def test_split_route_takes_float32_up_to_dh_128(dh, dhp):
    q, k, v = _bhsd(dh, dtype=torch.float32)
    assert route(q, k, v) == "split_f32" and tensor_core_route(q, k, v)
    assert tile_width("split_f32", dh) == dhp


@pytest.mark.parametrize("dh", [136, 160, 256])
def test_split_route_leaves_float32_past_dh_128(dh):
    """stablelm's dh 160 in f32 (only its f32 check launches it) and
    anything wider up to 256 stay on the split route: dh 136 and 160 on
    its DHP-192 instantiation, 256 on DHP 256."""
    q, k, v = _bhsd(dh, dtype=torch.float32)
    assert route(q, k, v) == "split_f32" and tensor_core_route(q, k, v)
    assert tile_width("split_f32", dh) == {136: 192, 160: 192, 256: 256}[dh]


@pytest.mark.parametrize("pad,offset", [(2, 0), (0, 2)])
def test_split_route_leaves_views_no_tensor_map_takes(pad, offset):
    """f32 rows 130 elements apart (520 bytes, not whole 16-byte units), or
    a base 8 bytes off a 16-byte boundary: the split route still takes
    them, since its pass reads any strides and writes contiguous parts."""
    q, k, v = _bhsd(128, dtype=torch.float32, pad=pad, offset=offset)
    assert q.data_ptr() % 16 or q.stride(2) * 4 % 16
    assert route(q, k, v) == "split_f32" and tensor_core_route(q, k, v)
    assert tile_width("split_f32", 128) == 128


@pytest.mark.parametrize("scale", [1.0, 1e-20, 3e20])
def test_split_bf16x3_ref_parts_sum_back_bitwise(scale):
    """hi + mid + lo (summed from the top) is x to its last bit, on
    seeded normal float32 inputs at three magnitudes; hi and mid are the
    roundings of x and of x - hi."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 50, 24)).astype(np.float32)) * scale
    parts = split_bf16x3_ref(x)
    assert parts.shape == (3,) + x.shape and parts.dtype == torch.bfloat16
    hi, mid, lo = parts.float()
    assert torch.equal((hi + mid) + lo, x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.equal(mid, (x - hi).to(torch.bfloat16).float())


def _split_scheme(q, k, v, causal, window, q_offset, bn=32):
    """The split route's arithmetic, emulated in float32 on the CPU: q, k,
    v [B,H,S,dh] as three bf16 parts each; per tile of ``bn`` keys S =
    sum of Q_a K_b^T over a + b <= 2, scaled and masked, the online
    softmax, then O += sum of P_a V_b over the same pairs, P split as the
    kernel splits it; o = acc / max(l, 1e-30)."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    pairs = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
    qp, kp, vp = (split_bf16x3_ref(t).float() for t in (q, k, v))
    kp, vp = (t.repeat_interleave(G, dim=2) for t in (kp, vp))
    qpos = torch.arange(Sq)[:, None] + q_offset
    m = torch.full((B, Hq, Sq, 1), -1e30)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, dh))
    for k0 in range(0, Sk, bn):
        ks = slice(k0, min(k0 + bn, Sk))
        s = sum(qp[a] @ kp[b][:, :, ks].transpose(-1, -2) for a, b in pairs)
        s = s / dh ** 0.5
        kpos = torch.arange(k0, min(k0 + bn, Sk))[None, :]
        ok = torch.ones_like(s[0, 0], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(m_new <= -5e29, torch.tensor(0.0), m_new)
        corr = torch.where(m <= -5e29, torch.tensor(0.0),
                           torch.exp(m - m_safe))
        p = torch.exp(s - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        m = m_new
        pp = split_bf16x3_ref(p).float()
        acc = acc * corr + sum(pp[a] @ vp[b][:, :, ks] for a, b in pairs)
    return acc / torch.clamp(l, min=1e-30)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window,q_offset", CASES)
def test_split_scheme_matches_reference_ref(B, Sq, Sk, Hq, Hkv, dh, causal,
                                            window, q_offset):
    """The six-product scheme holds the f32 limit before any card runs it:
    the emulation against the reference's ``flash_attention_ref``."""
    q, k, v = (x.transpose(0, 2, 1, 3) for x in
               _inputs(B, Sq, Sk, Hq, Hkv, dh, seed=Sq + Sk))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = _split_scheme(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), bn=_split_keys(dh), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def _split_keys(dh):
    """Keys a K/V tile of the split route's instantiation at head dim
    ``dh`` (``Tile::BN`` in ``csrc/flash_attention.cu``): 32 up to DHP 192,
    16 at DHP 256, where 32-key tiles do not fit."""
    return 32 if tile_width("split_f32", dh) <= 192 else 16


@pytest.mark.parametrize("shape,pad,offset", [
    ((2, 3, 5, 37), 0, 0), ((1, 4, 9, 64), 4, 0), ((2, 2, 7, 161), 0, 2),
    ((1, 3, 6, 192), 4, 1)])
def test_pack_bf16_ref_is_the_input_zero_padded(shape, pad, offset):
    """The pack's plain version on views (rows ``pad`` elements wider than
    ``dh``, a base ``offset`` elements in): contiguous, the input bitwise
    in the first ``dh`` columns, zeros up to ``dh`` rounded up to 8."""
    B, H, S, dh = shape
    x = torch.from_numpy(np.random.default_rng(dh).standard_normal(
        offset + B * H * S * (dh + pad)).astype(np.float32)).to(
        torch.bfloat16)
    x = x[offset:].view(B, H, S, dh + pad)[..., :dh]
    got = pack_bf16_ref(x)
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    assert got.shape == (B, H, S, -(-dh // 8) * 8)
    assert torch.equal(got[..., :dh].view(torch.int16), x.view(torch.int16))
    assert not got[..., dh:].view(torch.int16).any()


@pytest.mark.parametrize("dh,dhp", [(129, 192), (160, 192), (192, 192),
                                    (193, 256), (256, 256)])
def test_split_route_tile_width_past_dh_128(dh, dhp):
    """The split route's wide instantiations: DHP 192 for dh in (128, 192],
    DHP 256 above; the f32 inputs of each take the split route."""
    assert tile_width("split_f32", dh) == dhp
    assert route(*_bhsd(dh, dtype=torch.float32)) == "split_f32"


@pytest.mark.parametrize("dh", [64, 160, 256])
def test_wgmma_route_packs_only_views_no_tensor_map_takes(dh):
    """Only the operands no tensor map takes are packed: k in rows 4
    elements wider than dh (8 bytes more: not whole 16-byte units) is, q
    and v in rows of whole 16-byte units are not."""
    q, _, v = _bhsd(dh)
    k = _bhsd(dh, pad=4)[1]
    assert route(q, k, v) == "wgmma" and packed(q, k, v) == (False, True,
                                                              False)


@pytest.mark.parametrize("dtype,dh", [(torch.float16, 64),
                                      (torch.bfloat16, 264),
                                      (torch.float32, 264)])
def test_route_takes_nothing_outside_its_dtypes_and_head_dims(dtype, dh):
    """float16, or a head dim past 256, is taken by no route."""
    assert route(*_bhsd(dh, dtype=dtype)) is None
    assert not tensor_core_route(*_bhsd(dh, dtype=dtype))
