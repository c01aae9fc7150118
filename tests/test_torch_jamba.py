"""Port: the hybrid family (jamba-v0.1 smoke config) against the JAX model.

The reference model's parameter tree (its structure and shapes from
``init_params`` via ``jax.eval_shape``) is filled from a numpy seed at the
reference's scales and handed to both frameworks
(``model_params_from_jax`` on the port's side). Prefill logits and decode
states, decode steps, and the batch CLI's greedy tokens on the reference's
prompt tokens are held at the reference's 5e-3 model tolerance; prefill of
S + n tokens equals prefill of S then n decode steps in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.paging import kv_cache as jkv  # noqa: E402
from repro.runtime.straggler import StepTimeMonitor as JMonitor  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.paging import kv_cache as tkv  # noqa: E402
from repro_torch.runtime.straggler import StepTimeMonitor  # noqa: E402

ARCH = "jamba_v01_52b"
TOL = 5e-3
CPU = "cpu"


def _leaf(path, shape, rng):
    name = jax.tree_util.keystr(path[-1:]).strip("[]'")
    if name == "embed":
        return 0.02 * rng.standard_normal(shape)
    if name in ("scale", "d_skip"):
        return 1 + 0.1 * rng.standard_normal(shape)
    if name == "a_log":
        return np.broadcast_to(np.log(np.arange(1, shape[-1] + 1)), shape)
    if name == "dt_bias":
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
        return np.log(np.expm1(dt))
    return rng.standard_normal(shape) / np.sqrt(shape[-2])   # fan-in


@pytest.fixture(scope="module")
def models():
    """(reference model, its params, the port's converted model), built
    once for this file."""
    cfg = jcfg.get_smoke_config(ARCH)
    model = j_build(cfg)
    shapes = jax.eval_shape(lambda k: model.init_params(k)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params_np = jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_leaf(p, s.shape, rng), s.dtype), shapes)
    tm = model_params_from_jax(params_np, tcfg.get_smoke_config(ARCH), CPU)
    return model, jax.tree.map(jnp.asarray, params_np), tm


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


def test_configs_match_the_reference(models):
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jcfg, get)(ARCH), getattr(tcfg, get)(ARCH)
        assert j.__dict__ == t.__dict__
        assert j.param_count() == t.param_count()
        assert j.layer_kinds() == t.layer_kinds()
    _, _, tm = models
    kinds = [(b.kind["mix"], b.kind["ff"]) for b in tm.blocks]
    assert kinds == [("mamba", "mlp"), ("mamba", "moe")] * 2 \
        + [("attn", "mlp"), ("mamba", "moe")] + [("mamba", "mlp"),
                                                  ("mamba", "moe")]


def test_prefill_and_decode_match_jax(models):
    model, params, tm = models
    toks = _tokens((2, 7), seed=1)
    jl, jst = jax.jit(model.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks)}, 12)
    tl, tst = tm.prefill(torch.from_numpy(toks), 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    # the period stacks the reference's state [n_periods=1, ...]
    for layer, blk in enumerate(tst["blocks"]):
        for key, t in blk.items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jst["blocks"][layer][key][0]),
                rtol=TOL, atol=TOL)
    step = jax.jit(model.decode_step)
    for j in range(3):
        nt = _tokens((2,), seed=10 + j)
        jl, jst = step(params, jnp.asarray(nt), jst)
        tl, tst = tm.decode_step(torch.from_numpy(nt), tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
    assert tst["pos"] == int(jst["pos"]) == 10


def test_prefill_equals_prefill_then_decode(models):
    _, _, tm = models
    toks = torch.from_numpy(_tokens((2, 10), seed=2))
    full, _ = tm.prefill(toks, 12)
    logits, st = tm.prefill(toks[:, :6], 12)
    for t in range(6, 10):
        logits, st = tm.decode_step(toks[:, t], st)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=TOL,
                               atol=TOL)


def test_batch_cli_tokens_match_jax_greedy_decode(models):
    """The port's lock-step path on the reference's prompt tokens (drawn as
    its ``_main_batch`` draws them) emits the reference model's greedy
    tokens."""
    model, params, tm = models
    B, P, G = 2, 8, 4
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, P), 0,
                                            512))
    logits, st = model.prefill(params, {"tokens": jnp.asarray(prompts)},
                               P + G)
    step = jax.jit(model.decode_step)
    want = [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(G - 1):
        logits, st = step(params, jnp.asarray(want[-1], jnp.int32), st)
        top2 = np.sort(np.asarray(logits), -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 2 * TOL   # a clear argmax
        want.append(np.asarray(jnp.argmax(logits, -1)))
    args = tserve.build_parser().parse_args(
        ["--arch", ARCH, "--smoke", "--device", CPU, "--batch", str(B),
         "--prompt-len", str(P), "--gen", str(G)])
    res = tserve._main_batch(args, model=tm, prompts=prompts)
    assert res["tokens"] == np.stack(want, 1).tolist()
    assert res["tokens_shape"] == [B, G]
    assert res["step_time_monitor"]["steps"] == G - 1


@pytest.mark.parametrize("stride", [1, 3])
def test_page_table_and_append_match_the_reference(stride):
    np.testing.assert_array_equal(
        tkv.linear_page_table(3, 5, stride, device=CPU).numpy(),
        np.asarray(jkv.linear_page_table(3, 5, stride)))
    pool = tkv.init_paged_kv(2, 15, 4, 2, 3, torch.float32, CPU)
    jpool = jkv.init_paged_kv(2, 15, 4, 2, 3, jnp.float32)
    pt = tkv.linear_page_table(3, 5, stride, device=CPU)
    rng = np.random.default_rng(stride)
    for pos in (0, 5, 13):
        k, v = (rng.standard_normal((3, 2, 3)).astype(np.float32)
                for _ in range(2))
        tkv.append_kv(pool, 1, torch.from_numpy(k), torch.from_numpy(v), pt,
                      pos)
        jpool = jkv.append_kv(jpool, jnp.int32(1), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(pt.numpy()),
                              jnp.int32(pos))
    for key in ("k", "v"):
        np.testing.assert_array_equal(pool[key].numpy(),
                                      np.asarray(jpool[key]))


def test_page_table_rejects_a_colliding_stride():
    with pytest.raises(ValueError, match="coprime"):
        tkv.linear_page_table(2, 4, 2, device=CPU)


def test_step_time_monitor_is_the_reference_copy():
    times = [1.0, 1.1, 0.9, 1.0, 1.2, 1.0, 5.0, 1.0, 0.95]
    a, b = StepTimeMonitor(), JMonitor()
    flags = [(a.record(t), b.record(t)) for t in times]
    assert all(x == y for x, y in flags) and any(x for x, _ in flags)
    assert a.summary() == b.summary()
