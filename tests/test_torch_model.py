"""Port: the dense model and ``ModelExecutor`` against the JAX package.

The reference's ``init_params`` tree (qwen2.5-3b smoke config, f32) is
converted with ``model_params_from_jax``; the same tokens go through both
frameworks. Logits, the decode caches and the executor's mirrored K/V are
held at the reference's 5e-3 model tolerance (its chunked-vs-one-shot
bound, ``tests/test_serving.py``); on the CPU in f32 they agree to ~1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.serving.executor import ModelExecutor as JExecutor  # noqa: E402
from repro.serving.request import PREFILL as J_PREFILL  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import (apply_norm, apply_rotary,  # noqa: E402
                                       rope_angles)
from repro_torch.serving.executor import ModelExecutor  # noqa: E402
from repro_torch.serving.request import PREFILL, Request  # noqa: E402

ARCH = "qwen2_5_3b"
TOL = 5e-3          # the reference's model tolerance
CPU = "cpu"


@functools.lru_cache(maxsize=1)
def _jax_model():
    cfg = jcfg.get_smoke_config(ARCH)
    model = j_build(cfg)
    params, _ = model.init_params(jax.random.PRNGKey(0))
    return model, params


@functools.lru_cache(maxsize=1)
def _converted():
    _, params = _jax_model()
    return model_params_from_jax(jax.tree.map(np.asarray, params),
                                 tcfg.get_smoke_config(ARCH), CPU)


def _tokens(n, seed=0):
    cfg = jcfg.get_smoke_config(ARCH)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                n).astype(np.int32)


def test_configs_match_the_reference():
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jcfg, get)(ARCH), getattr(tcfg, get)(ARCH)
        assert j.__dict__ == t.__dict__
        assert j.param_count() == t.param_count()
        assert j.layer_kinds() == t.layer_kinds()
    assert tcfg.get_config("qwen2.5-3b").n_layers == 36
    assert tcfg.ARCHS == jcfg.ARCHS and tcfg.ALIASES == jcfg.ALIASES


@pytest.mark.parametrize("arch", ["xlstm_350m", "phi35_moe_42b"])
def test_unported_configs_raise_naming_the_roadmap(arch):
    """Every arch is ported now: each loads the reference's config, and
    none raises. (The id is kept from when both raised.)"""
    assert tcfg.canonical(arch) in tcfg.PORTED
    for get in ("get_config", "get_smoke_config"):
        assert getattr(tcfg, get)(arch).__dict__ == \
            getattr(jcfg, get)(arch).__dict__
    assert set(tcfg.ARCHS) == set(tcfg.PORTED)


def test_unported_layer_kinds_raise():
    """A GELU MoE builds since the families that use GELU were ported, and
    its MoE layer gives the reference's output; the MoE family builds its
    interleave. (The id is kept from when a GELU MoE raised.)"""
    import dataclasses
    from repro.models.moe import apply_moe as j_moe
    moe = dataclasses.replace(tcfg.get_smoke_config(ARCH), family="moe",
                              moe_every=2, n_experts=4, top_k=2)
    kinds = [b.kind["ff"] for b in build_model(moe, device=CPU).blocks]
    assert kinds == [k["ff"] for k in moe.layer_kinds()] and "moe" in kinds
    gelu = build_model(dataclasses.replace(moe, act="gelu"), device=CPU)
    layer = next(b.ff for b in gelu.blocks if b.kind["ff"] == "moe")
    x = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(
        np.float32)
    want, _ = j_moe({k: jnp.asarray(v.numpy()) for k, v in layer.p().items()},
                    jnp.asarray(x), 2, act="gelu", dropless=True)
    np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 5])
def test_layers_match_jax(n):
    from repro.models import layers as jl
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(7, 7 + n)
    ja = jl.rope_angles(jnp.asarray(pos), 16, 1e6)
    ta = rope_angles(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)
    want = jl.apply_rotary(jnp.asarray(x), ja[None, :, None, :])
    got = apply_rotary(torch.from_numpy(x), ta[None, :, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = jl.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                         "rmsnorm")
    got = apply_norm(torch.from_numpy(scale), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_decode_step_logits_and_cache_match_jax():
    model, params = _jax_model()
    tm = _converted()
    toks = _tokens(7)
    jst = model.init_decode_state(1, 12)
    tst = tm.init_decode_state(1, 12)
    step = jax.jit(model.decode_step)
    for j in range(7):
        jl, jst = step(params, jnp.asarray(toks[j:j + 1]), jst)
        tl, tst = tm.decode_step(torch.from_numpy(toks[j:j + 1]), tst)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
    assert tst["pos"] == int(jst["pos"]) == 7
    for layer, blk in enumerate(tst["blocks"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                blk[key].numpy(), np.asarray(jst["blocks"][0][key][layer]),
                rtol=TOL, atol=TOL)


def test_prefill_matches_jax():
    model, params = _jax_model()
    tm = _converted()
    toks = _tokens(7, seed=1)[None]
    jl, jst = model.prefill(params, {"tokens": jnp.asarray(toks)}, 12)
    tl, tst = tm.prefill(torch.from_numpy(toks), 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    assert tst["pos"] == int(jst["pos"]) == 7
    np.testing.assert_allclose(tst["blocks"][1]["k"].numpy(),
                               np.asarray(jst["blocks"][0]["k"][1]),
                               rtol=TOL, atol=TOL)


def test_mirrored_kv_matches_the_reference_executor():
    """The K/V ``prefill_chunk`` / ``decode`` hand the engine (the first
    attention layer's roped K/V at the input token's position), on the
    reference's prompt tokens."""
    jex = JExecutor(jcfg.get_smoke_config(ARCH), seed=0)
    params = jax.tree.map(np.asarray, jex.params)
    jreq = JRequest(4, prompt_len=7, gen=3)
    prompts = {4: np.asarray(jex.prompt_tokens(jreq))}
    tex = ModelExecutor(tcfg.get_smoke_config(ARCH), device=CPU,
                        model=model_params_from_jax(
                            params, tcfg.get_smoke_config(ARCH), CPU),
                        prompts=prompts)
    treq = Request(4, prompt_len=7, gen=3)
    for ex, req, state in ((jex, jreq, J_PREFILL), (tex, treq, PREFILL)):
        req.to(state, 0)
        ex.begin(req)
    outs = []
    for ex, req in ((jex, jreq), (tex, treq)):
        k1, v1, t1 = ex.prefill_chunk(req, 4)
        req.advance_prefill(4, 0)
        k2, v2, t2 = ex.prefill_chunk(req, 3)
        req.advance_prefill(3, 1)
        k3, v3, t3 = ex.decode(req)
        outs.append([np.asarray(a) for a in (k1, v1, k2, v2, k3, v3)]
                    + [t1, t2, t3])
    (*jkv, jt1, jt2, jt3), (*tkv, tt1, tt2, tt3) = outs
    for a, b in zip(jkv, tkv):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    assert jt1 is None and tt1 is None
    assert (jt2, jt3) == (tt2, tt3)
    np.testing.assert_allclose(tex.last_logits[4].numpy(),
                               np.asarray(jex.last_logits[4]), rtol=TOL,
                               atol=TOL)


@functools.lru_cache(maxsize=1)
def _port_executor():
    return ModelExecutor(tcfg.get_smoke_config(ARCH), seed=0, device=CPU)


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_chunked_prefill_matches_oneshot(chunk):
    """As the reference's ``TestChunkedPrefillEquivalence``: feeding the
    prompt token by token in chunks gives the one-shot prefill's
    first-token logits at 5e-3 and the same greedy token."""
    ex = _port_executor()
    req = Request(100 + chunk, prompt_len=7, gen=2)
    req.to(PREFILL, 0)
    ex.begin(req)
    tok = None
    while req.state == PREFILL:
        n = min(chunk, req.prompt_len - req.prefilled)
        _, _, tok = ex.prefill_chunk(req, n)
        req.advance_prefill(n, 0)
    chunked = ex.last_logits[req.req_id].numpy()
    oneshot = ex.oneshot_prefill_logits(req).numpy()
    ex.end(req)
    np.testing.assert_allclose(chunked, oneshot, rtol=TOL, atol=TOL)
    assert tok == int(chunked.argmax()) == int(oneshot.argmax())


def test_prompt_tokens_are_keyed_by_seed_and_request():
    ex = _port_executor()
    a = ex.prompt_tokens(Request(1, prompt_len=6, gen=1))
    b = ModelExecutor(tcfg.get_smoke_config(ARCH), seed=0,
                      device=CPU, model=ex.model).prompt_tokens(
        Request(1, prompt_len=6, gen=1))
    c = ex.prompt_tokens(Request(2, prompt_len=6, gen=1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 512
