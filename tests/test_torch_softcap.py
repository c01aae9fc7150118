"""Port: attention logit soft-capping against the JAX package.

The cap (``s = tanh(s / cap) * cap`` on the scaled scores, before the
mask) on every attention route of the port, held against the reference's
on the same numpy-seeded inputs:

* the flash kernel's plain version (``flash_attention_ref(softcap=)``,
  and the ``flash_attention`` wrapper that takes it on the CPU) against
  the reference's ``full_attention(softcap=)`` and
  ``blocked_attention(softcap=)``, causal, windowed and bidirectional,
  within 2e-5 in f32;
* ``train_attention(softcap=)`` against the reference's
  ``blocked_attention`` within 2e-5, and ``decode_attention(softcap=)``
  against the reference's ``decode_attention`` within 2e-5 (a host length
  and a per-row one);
* qwen2.5-3b's smoke config with ``attn_logit_softcap`` set, its query
  and key weights scaled by 4 in both models so that the smoke's scores
  reach the cap: prefill logits and state and decode logits within the
  5e-3 model tolerance, and the train loss and gradients against
  ``jax.value_and_grad`` within 1e-5 / 1e-4.

Every case uses a cap that bites (1.0-3.0), and asserts that the capped
result differs from the cap-free one by more than 100x its tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.data import make_pipeline as j_pipeline  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import (grads_to_jax, model_params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

ATTN_TOL = 2e-5      # the reference's kernel-vs-exact bound, f32
MODEL_TOL = 5e-3     # the reference's model tolerance
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
ARCH = "qwen2_5_3b"
CAP = 1.0            # the model's cap: bites once wq / wk are scaled
QK_SCALE = 4.0
S, MAX_LEN, N_DECODE = 12, 20, 4

# B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset, cap
ATTN_CASES = [
    (2, 24, 24, 8, 2, 16, True, 0, 0, 1.0),       # causal, GQA
    (2, 24, 24, 8, 2, 16, True, 6, 0, 2.0),       # sliding window
    (1, 10, 32, 4, 1, 32, True, 8, 22, 1.5),      # window + offset, MQA
    (2, 20, 16, 4, 4, 16, False, 0, 0, 3.0),      # bidirectional, Sq > Sk
]


def _qkv(B, Sq, Sk, Hq, Hkv, dh, seed):
    """q [B,Sq,Hq,dh], k/v [B,Sk,Hkv,dh] f32 (scores of unit scale)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 1.5).astype(np.float32)
    return r(B, Sq, Hq, dh), r(B, Sk, Hkv, dh), r(B, Sk, Hkv, dh)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _diff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window,q_offset,cap",
                         ATTN_CASES)
def test_flash_ref_softcap_matches_the_reference(B, Sq, Sk, Hq, Hkv, dh,
                                                 causal, window, q_offset,
                                                 cap):
    """``flash_attention_ref`` (the kernel's plain version, in the
    kernel's ``[B, H, S, dh]`` layout) and the ``flash_attention`` wrapper
    on CPU tensors against the reference's ``full_attention`` and
    ``blocked_attention`` with the same cap."""
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, dh, seed=Sq + dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    full = jattn.full_attention(*map(jnp.asarray, (q, k, v)), softcap=cap,
                                **kw)
    blocked = jattn.blocked_attention(*map(jnp.asarray, (q, k, v)),
                                      softcap=cap, block_q=8, block_k=8,
                                      **kw)
    free = jattn.full_attention(*map(jnp.asarray, (q, k, v)), **kw)
    tq, tk, tv = _t(q, k, v)
    ref = flash_attention_ref(*(t.transpose(1, 2) for t in (tq, tk, tv)),
                              softcap=cap, **kw).transpose(1, 2)
    wrapped = flash_attention(tq, tk, tv, softcap=cap, **kw)
    for got in (ref, wrapped):
        assert got.shape == (B, Sq, Hq, dh) and got.dtype == torch.float32
        assert _diff(got, full) <= ATTN_TOL
        assert _diff(got, blocked) <= ATTN_TOL
    assert _diff(full, free) > 100 * ATTN_TOL


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window,q_offset,cap",
                         [c for c in ATTN_CASES if c[1] == c[2]
                          and c[8] == 0])
def test_train_attention_softcap_matches_blocked_attention(
        B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset, cap):
    """The train route (query chunks, each an online-softmax sweep over
    key blocks, the cap on each block before its mask) against the
    reference's ``blocked_attention`` at the same blocks; its gradient
    through the cap is finite."""
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, dh, seed=3 * Sq + dh)
    kw = dict(causal=causal, window=window, block_q=8, block_k=8)
    want = jattn.blocked_attention(*map(jnp.asarray, (q, k, v)),
                                   softcap=cap, **kw)
    free = jattn.blocked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    got = tattn.train_attention(tq, tk, tv, softcap=cap, **kw)
    assert _diff(got.detach(), want) <= ATTN_TOL
    assert _diff(want, free) > 100 * ATTN_TOL
    got.square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (tq, tk, tv))


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("cap", [1.0, 2.5])
def test_decode_attention_softcap_matches_the_reference(per_row, cap):
    """One query position against a cache of 24 slots, masked to a host
    length of 17 or to per-row lengths (9, 24), the cap after the scale
    and before the mask."""
    q, k, v = _qkv(2, 1, 24, 8, 2, 16, seed=11)
    length = np.array([9, 24], np.int32) if per_row else 17
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v)),
                                  jnp.asarray(length), softcap=cap)
    free = jattn.decode_attention(*map(jnp.asarray, (q, k, v)),
                                  jnp.asarray(length))
    tl = torch.from_numpy(length) if per_row else length
    got = tattn.decode_attention(*_t(q, k, v), tl, softcap=cap)
    assert got.shape == (2, 1, 8, 16)
    assert _diff(got, want) <= ATTN_TOL
    assert _diff(want, free) > 100 * ATTN_TOL


# --------------------------------------------------------------------------
# qwen2.5-3b's smoke config with the cap
# --------------------------------------------------------------------------
def _scale_qk(params):
    """The reference's parameter tree with every ``wq`` / ``wk`` leaf
    times ``QK_SCALE`` (numpy)."""
    def one(path, a):
        a = np.asarray(a)
        last = getattr(path[-1], "key", None)
        return a * np.float32(QK_SCALE) if last in ("wq", "wk") else a
    return jax.tree_util.tree_map_with_path(one, params)


@functools.lru_cache(maxsize=None)
def _models(cap):
    """(reference model, its numpy params, the port's converted model) of
    qwen2.5-3b's smoke config at ``cap`` (0: none)."""
    jc = dataclasses.replace(jcfg.get_smoke_config(ARCH),
                             attn_logit_softcap=cap)
    tc = dataclasses.replace(tcfg.get_smoke_config(ARCH),
                             attn_logit_softcap=cap)
    model = j_build(jc)
    params = _scale_qk(model.init_params(jax.random.PRNGKey(0))[0])
    return model, params, model_params_from_jax(params, tc, "cpu")


def _tokens(seed):
    vocab = jcfg.get_smoke_config(ARCH).vocab_size
    return np.random.default_rng(seed).integers(
        0, vocab, (2, S + N_DECODE)).astype(np.int32)


def test_capped_model_prefill_and_decode_match_the_reference():
    """Prefill logits and K/V caches, then ``N_DECODE`` decode steps'
    logits, against the reference's at 5e-3; the cap moves the prefill
    logits by more than 100x that."""
    model, params, tm = _models(CAP)
    toks = _tokens(1)
    jp = jax.tree.map(jnp.asarray, params)
    jlog, jst = jax.jit(model.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :S])}, MAX_LEN)
    tlog, tst = tm.prefill(torch.from_numpy(toks[:, :S]), MAX_LEN)
    assert _diff(tlog, jlog) <= MODEL_TOL
    flog, _ = _models(0.0)[2].prefill(torch.from_numpy(toks[:, :S]),
                                      MAX_LEN)
    assert _diff(flog, tlog) > 100 * MODEL_TOL
    P = tm.cfg.scan_period()
    for layer, blk in enumerate(tst["blocks"]):
        for name, t in blk.items():
            want = np.asarray(jst["blocks"][layer % P][name][layer // P])
            assert _diff(t, want) <= MODEL_TOL, (layer, name)
    step = jax.jit(model.decode_step)
    for t in range(S, S + N_DECODE):
        jlog, jst = step(jp, jnp.asarray(toks[:, t]), jst)
        tlog, tst = tm.decode_step(torch.from_numpy(toks[:, t]), tst)
        assert _diff(tlog, jlog) <= MODEL_TOL, t


def test_capped_model_train_loss_and_grads_match_the_reference():
    """``train_forward`` with the cap: the loss within 1e-5 of
    ``jax.value_and_grad``'s, every gradient leaf within 1e-4 of its
    largest magnitude; the cap moves the loss."""
    model, params, _ = _models(CAP)
    tc = dataclasses.replace(tcfg.get_smoke_config(ARCH),
                             attn_logit_softcap=CAP)
    batch = j_pipeline(model.cfg.vocab_size, 2, 16, seed=1).peek(0)
    jp = jax.tree.map(jnp.asarray, params)
    want_loss, want = jax.jit(jax.value_and_grad(model.train_forward))(
        jp, batch)
    free_loss = jax.jit(_models(0.0)[0].train_forward)(jp, batch)
    assert abs(float(want_loss) - float(free_loss)) > 100 * LOSS_TOL
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), params)
    tm, _ = train_state_from_jax(params, {"m": zeros, "v": zeros}, tc,
                                 "adamw", "cpu")
    loss = tm.train_forward({k: torch.from_numpy(v)
                             for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_TOL
    got = grads_to_jax(tm, tc)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= GRAD_TOL * max(
            float(np.abs(w).max()), 1e-30)
