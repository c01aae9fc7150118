"""Port: the kernels' plain PyTorch versions against the JAX ops (Pallas in
interpret mode on the CPU). The CUDA kernels against their plain versions
are in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.gather_pages import gather_pages as j_gather  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention as j_attn, paged_attention_hot_slots as j_hot)
from repro_torch.convert import array_from_numpy, array_to_numpy  # noqa: E402
from repro_torch.kernels.gather_pages import ops as kg  # noqa: E402
from repro_torch.kernels.paged_attention import ops as ka  # noqa: E402

SHAPES = [  # B/S, Hq, Hkv, dh, page, npps: GQA, MHA, MQA
    (2, 8, 2, 64, 16, 4),
    (1, 4, 4, 32, 8, 8),
    (3, 4, 1, 128, 32, 2),
]
DTYPES = [(jnp.float32, torch.float32, 2e-5),
          (jnp.bfloat16, torch.bfloat16, 2e-2)]


def _normal(rng, shape, jdt):
    a = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(a, jdt))


def _f32(x):
    return np.asarray(x, np.float32)


class TestGatherPlain:
    @pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16, jnp.int32])
    @pytest.mark.parametrize("use_async", [False, True])
    def test_bytes_exact_with_clamping(self, jdt, use_async):
        rng = np.random.default_rng(0)
        pool = np.asarray(jnp.asarray(rng.standard_normal((32, 4, 2, 3)) * 9,
                                      jdt))
        idx = np.array([0, 31, 7, 7, -5, 100, 13], np.int32)
        # the reference's async kernel is red on this JAX; its documented
        # identical-bytes stand-in is use_kernel=False
        want = np.asarray(j_gather(jnp.asarray(pool), jnp.asarray(idx),
                                   interpret=True))
        fn = kg.gather_pages_async if use_async else kg.gather_pages
        got = fn(array_from_numpy(pool, "cpu"), torch.from_numpy(idx))
        got = array_to_numpy(got)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


class TestPagedAttentionPlain:
    @pytest.mark.parametrize("B,Hq,Hkv,dh,ps,npps", SHAPES)
    @pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
    def test_flat_vs_jax_with_poisoned_table(self, B, Hq, Hkv, dh, ps, npps,
                                             jdt, tdt, tol):
        rng = np.random.default_rng(1)
        n_pages = npps * B + 4
        q = _normal(rng, (B, 1, Hq, dh), jdt)
        kp = _normal(rng, (n_pages, ps, Hkv, dh), jdt)
        vp = _normal(rng, (n_pages, ps, Hkv, dh), jdt)
        pt = rng.integers(0, n_pages, (B, npps)).astype(np.int32)
        pt[0, -1] = -1
        pt[-1, 0] = n_pages + 3
        ln = rng.integers(ps + 1, ps * npps + 1, B).astype(np.int32)
        want = j_attn(*(jnp.asarray(a) for a in (q, kp, vp, pt, ln)),
                      interpret=True)
        got = ka.paged_attention(*(array_from_numpy(a, "cpu")
                                   for a in (q, kp, vp, pt, ln)))
        assert got.dtype == tdt
        np.testing.assert_allclose(_f32(array_to_numpy(got)), _f32(want),
                                   atol=tol, rtol=tol)

    @pytest.mark.parametrize("S,Hq,Hkv,dh,ps,npps", SHAPES)
    @pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
    def test_hot_slots_vs_jax_masks_invalid_slots(self, S, Hq, Hkv, dh, ps,
                                                  npps, jdt, tdt, tol):
        rng = np.random.default_rng(2)
        n_slots = npps + 3
        q = _normal(rng, (S, 1, Hq, dh), jdt)
        kh = _normal(rng, (S, n_slots, ps, Hkv, dh), jdt)
        vh = _normal(rng, (S, n_slots, ps, Hkv, dh), jdt)
        st = rng.integers(0, n_slots, (S, npps)).astype(np.int32)
        st[0, 0] = -1
        st[-1, -1] = n_slots + 9
        ln = np.full((S,), ps * npps, np.int32)
        want = j_hot(*(jnp.asarray(a) for a in (q, kh, vh, st, ln)),
                     interpret=True)
        got = ka.paged_attention_hot_slots(*(array_from_numpy(a, "cpu")
                                             for a in (q, kh, vh, st, ln)))
        np.testing.assert_allclose(_f32(array_to_numpy(got)), _f32(want),
                                   atol=tol, rtol=tol)

    @pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
    def test_plain_hot_slots_bitwise_equals_plain_flat(self, jdt, tdt, tol):
        rng = np.random.default_rng(3)
        S, Hq, Hkv, dh, ps, npps = 3, 8, 2, 16, 4, 5
        n_slots = npps + 2
        q = torch.from_numpy(rng.standard_normal((S, 1, Hq, dh))).to(tdt)
        kh = torch.from_numpy(
            rng.standard_normal((S, n_slots, ps, Hkv, dh))).to(tdt)
        vh = torch.from_numpy(
            rng.standard_normal((S, n_slots, ps, Hkv, dh))).to(tdt)
        st = torch.from_numpy(
            rng.integers(-1, n_slots + 1, (S, npps)).astype(np.int32))
        ln = torch.tensor([20, 7, 1], dtype=torch.int32)
        hot = ka.paged_attention_hot_slots(q, kh, vh, st, ln)
        base = torch.arange(S, dtype=torch.int32)[:, None] * n_slots
        gt = torch.where((st >= 0) & (st < n_slots), st + base,
                         torch.full_like(st, -1))
        flat = ka.paged_attention(q, kh.reshape(S * n_slots, ps, Hkv, dh),
                                  vh.reshape(S * n_slots, ps, Hkv, dh), gt, ln)
        assert torch.equal(hot, flat)

    def test_async_copy_on_cpu_counts_no_launch(self):
        """On CPU tensors ``async_copy=True`` takes the plain version and
        adds nothing to any kernel's launch count."""
        from repro_torch.kernels import _build
        rng = np.random.default_rng(4)
        q = torch.from_numpy(rng.standard_normal((2, 1, 4, 8))).float()
        kh = torch.from_numpy(rng.standard_normal((2, 3, 2, 2, 8))).float()
        vh = torch.from_numpy(rng.standard_normal((2, 3, 2, 2, 8))).float()
        st = torch.tensor([[2, -1], [0, 7]], dtype=torch.int32)
        ln = torch.tensor([4, 3], dtype=torch.int32)
        _build.reset_counts()
        ka.paged_attention_hot_slots(q, kh, vh, st, ln, async_copy=True)
        assert set(_build.counts().values()) == {0}

    @pytest.mark.parametrize("S,Hq,Hkv,dh,ps,npps", SHAPES)
    def test_async_hot_slots_vs_jax_ref_and_sync_kernel(self, S, Hq, Hkv,
                                                        dh, ps, npps):
        """The async variant against the JAX plain version and the JAX
        sync hot-slot Pallas kernel (interpret mode) at 2e-5 in f32, on
        poisoned slot tables. The JAX async kernel does not run on this
        JAX, so it is no oracle here; both JAX kernels share one contract
        and are bitwise equal where they run."""
        rng = np.random.default_rng(5)
        n_slots = npps + 2
        q = _normal(rng, (S, 1, Hq, dh), jnp.float32)
        kh = _normal(rng, (S, n_slots, ps, Hkv, dh), jnp.float32)
        vh = _normal(rng, (S, n_slots, ps, Hkv, dh), jnp.float32)
        st = rng.integers(0, n_slots, (S, npps)).astype(np.int32)
        st[0, -1] = -1
        st[-1, 0] = n_slots + 4
        ln = rng.integers(ps + 1, ps * npps + 1, S).astype(np.int32)
        args = [jnp.asarray(a) for a in (q, kh, vh, st, ln)]
        got = ka.paged_attention_hot_slots(
            *(array_from_numpy(a, "cpu") for a in (q, kh, vh, st, ln)),
            async_copy=True).numpy()
        for want in (j_hot(*args, use_kernel=False),
                     j_hot(*args, interpret=True)):
            np.testing.assert_allclose(got, _f32(want), atol=2e-5,
                                       rtol=2e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.gather_pages.kernel import gather_pages_fwd
    from repro_torch.kernels.paged_attention.kernel import (
        paged_attention_fwd, paged_attention_hot_slots_async_fwd)
    with pytest.raises(ValueError, match="CUDA"):
        gather_pages_fwd(torch.zeros((4, 2)), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_fwd(torch.zeros((1, 1, 1, 4)),
                            torch.zeros((2, 2, 1, 4)),
                            torch.zeros((2, 2, 1, 4)),
                            torch.zeros((1, 1), dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_hot_slots_async_fwd(
            torch.zeros((1, 1, 1, 4)), torch.zeros((1, 2, 2, 1, 4)),
            torch.zeros((1, 2, 2, 1, 4)),
            torch.zeros((1, 1), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
