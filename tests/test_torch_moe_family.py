"""Port: the MoE family (phi3.5-moe and llama4-maverick smoke configs)
against the JAX model.

The reference's ``init_params(PRNGKey(0))`` tree of each smoke config (f32)
is converted with ``model_params_from_jax``, the shared expert included.
Prefill logits and caches and decode steps are held at the reference's
5e-3 model tolerance; prefill of S + n tokens equals prefill of S then n
decode steps in the port; ``--layers`` keeps llama4's dense / MoE period.
The batch path on phi's smoke model gives the reference ``_main_batch``'s
greedy tokens, report integers and sweep event log. llama4 behind the
continuous engine, and the CLI, are held in
``tests/test_torch_moe_serving.py``.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

ARCHS = ("phi35_moe_42b", "llama4_maverick_400b")
TOL = 5e-3
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(reference model, its params, their numpy tree, the port's
    converted model) for ``arch``'s smoke config."""
    model = j_build(jcfg.get_smoke_config(arch))
    params, _ = model.init_params(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    tm = model_params_from_jax(params_np, tcfg.get_smoke_config(arch), CPU)
    return model, params, params_np, tm


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    assert arch in tcfg.PORTED
    for get in ("get_config", "get_smoke_config"):
        j, t = getattr(jcfg, get)(arch), getattr(tcfg, get)(arch)
        assert j.__dict__ == t.__dict__
        assert j.param_count() == t.param_count()
        assert j.layer_kinds() == t.layer_kinds()


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_carry_across_shared_included(arch):
    _, _, params_np, tm = _models(arch)
    cfg = tcfg.get_smoke_config(arch)
    P = cfg.scan_period()
    shared = 0
    for layer, blk in enumerate(tm.blocks):
        ff = params_np["period"][layer % P]["ff"]
        for name in ("wr", "wg", "wu", "wd"):
            if name in ff:
                np.testing.assert_array_equal(
                    getattr(blk.ff, name).numpy(), ff[name][layer // P])
        if "shared" in ff:
            shared += 1
            assert blk.ff.shared.wg.shape == (cfg.d_model,
                                              cfg.ff_expert
                                              * cfg.n_shared_experts)
            for name in ("wg", "wu", "wd"):
                np.testing.assert_array_equal(
                    getattr(blk.ff.shared, name).numpy(),
                    ff["shared"][name][layer // P])
    kinds = [k["ff"] for k in cfg.layer_kinds()]
    assert shared == (kinds.count("moe") if cfg.n_shared_experts else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    model, params, _, tm = _models(arch)
    P = tcfg.get_smoke_config(arch).scan_period()
    toks = _tokens((2, 7), seed=1)
    jl, jst = jax.jit(model.prefill, static_argnums=2)(
        params, {"tokens": jnp.asarray(toks)}, 12)
    tl, tst = tm.prefill(torch.from_numpy(toks), 12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    for layer, blk in enumerate(tst["blocks"]):
        for key, t in blk.items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jst["blocks"][layer % P][key]
                                      [layer // P]), rtol=TOL, atol=TOL)
    step = jax.jit(model.decode_step)
    for j in range(3):
        nt = _tokens((2,), seed=10 + j)
        jl, jst = step(params, jnp.asarray(nt), jst)
        tl, tst = tm.decode_step(torch.from_numpy(nt), tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
    for layer, blk in enumerate(tst["blocks"]):
        for key, t in blk.items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jst["blocks"][layer % P][key]
                                      [layer // P]), rtol=TOL, atol=TOL)
    assert tst["pos"] == int(jst["pos"]) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_prefill_then_decode(arch):
    _, _, _, tm = _models(arch)
    toks = torch.from_numpy(_tokens((2, 10), seed=2))
    full, _ = tm.prefill(toks, 12)
    logits, st = tm.prefill(toks[:, :6], 12)
    for t in range(6, 10):
        logits, st = tm.decode_step(toks[:, t], st)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=TOL,
                               atol=TOL)


def test_layers_keeps_llama4_period():
    """``--layers`` cuts depth and keeps the interleave: llama4 stays dense
    at even layers and MoE at odd ones."""
    for n in (2, 4):
        args = tserve.build_parser().parse_args(
            ["--arch", "llama4_maverick_400b", "--layers", str(n)])
        cfg = tserve.model_config(args)
        assert cfg.n_layers == n and cfg.scan_period() == 2
        assert [k["ff"] for k in cfg.layer_kinds()] == ["mlp", "moe"] * (
            n // 2)


def test_phi_batch_path_matches_jax(tmp_path):
    """``_main_batch`` on phi's smoke model with the paged replay: the
    reference's greedy tokens on its prompts (drawn as its ``_main_batch``
    draws them), its report integers and its sweep event log."""
    import repro.launch.serve as jserve
    arch = "phi35_moe_42b"
    model, params, _, tm = _models(arch)
    B, P, G = 2, 16, 4
    argv = ["--arch", arch, "--smoke", "--batch", str(B), "--prompt-len",
            str(P), "--gen", str(G), "--page-size", "4", "--paged",
            "--chunk", "2", "--ring-size", "4"]
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = jserve._main_batch(jserve.build_parser().parse_args(
        argv + ["--trace", jpath]))
    prompts = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, P), 0,
                                            512))
    logits, st = model.prefill(params, {"tokens": jnp.asarray(prompts)},
                               P + G)
    step = jax.jit(model.decode_step)
    toks = [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(G - 1):
        logits, st = step(params, jnp.asarray(toks[-1], jnp.int32), st)
        top2 = np.sort(np.asarray(logits), -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 2 * TOL   # a clear argmax
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    got = tserve._main_batch(tserve.build_parser().parse_args(
        argv + ["--device", CPU, "--trace", tpath]), model=tm,
        prompts=prompts)
    assert got["tokens"] == np.stack(toks, 1).tolist()
    for key in ("tokens_shape", "tiered_equiv_ok", "tiered_streams",
                "tiered_n_slots", "paged_prefetch_hit_rate",
                "paged_pollution", "paged_ring_drops", "trace_events",
                "trace_totals_ok"):
        assert got[key] == want[key], key
    assert got["tiered_equiv_ok"] and got["trace_totals_ok"]
    read = lambda p: [json.loads(line) for line in
                      pathlib.Path(p + ".jsonl").read_text().splitlines()]
    assert read(tpath) == read(jpath)
