"""Port: the differentiable forward (``Transformer.train_forward``) against
the JAX package.

Loss and every gradient of ``Transformer.train_forward`` against
``jax.value_and_grad`` of the reference's ``train_forward`` on six smoke
configs, the port's model the reference's ``init_params(PRNGKey(0))``
tree converted by ``train_state_from_jax`` and both fed the same pipeline
batch: the loss within 1e-5, each gradient leaf within 1e-4 of its
largest magnitude, compared leaf by leaf in the reference's tree
(``grads_to_jax``). jamba runs at capacity factor 1.0, so its MoE layers
drop tokens. xLSTM and the encoder-decoder are held the same way at 2 x
16 (the encoder-decoder with seeded frames). Each reference gradient compiles once per module. (The
trainer CLI's tests are in ``test_torch_train_cli.py``.)
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.data import make_pipeline as j_pipeline  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import (grads_to_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.models import moe as tmoe  # noqa: E402

CPU = "cpu"
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
ARCHS = ("qwen2_5_3b", "jamba_v01_52b", "h2o_danube3_4b", "stablelm_12b",
         "phi35_moe_42b", "llama4_maverick_400b")
#: per arch: fields replaced in both configs (jamba's MoE drops tokens at
#: capacity factor 1.0: C = 8 slots an expert for 16 tokens x top-2)
OVERRIDES = {"jamba_v01_52b": {"capacity_factor": 1.0}}
B, S = 2, 16


def _configs(arch):
    kw = OVERRIDES.get(arch, {})
    return (dataclasses.replace(jcfg.get_smoke_config(arch), **kw),
            dataclasses.replace(tcfg.get_smoke_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(params numpy, batch, loss, grads numpy) of the reference."""
    jc, _ = _configs(arch)
    model = j_build(jc)
    params, _ = model.init_params(jax.random.PRNGKey(0))
    batch = j_pipeline(jc.vocab_size, B, S, seed=1).peek(0)
    loss, grads = jax.jit(jax.value_and_grad(model.train_forward))(
        params, batch)
    return (jax.tree.map(np.asarray, params), batch, float(loss),
            jax.tree.map(np.asarray, grads))


def _zero_opt(params_np):
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), params_np)
    return {"m": zeros, "v": zeros}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_loss_and_grads_match_jax(arch, monkeypatch):
    params_np, batch, want_loss, want = _reference(arch)
    _, tc = _configs(arch)
    model, _ = train_state_from_jax(params_np, _zero_opt(params_np), tc,
                                    "adamw", CPU)
    assert all(p.requires_grad for p in model.parameters())
    plans = []
    plan = tmoe.dispatch_plan
    monkeypatch.setattr(tmoe, "dispatch_plan",
                        lambda *a: plans.append(plan(*a)) or plans[-1])
    loss = model.train_forward({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL
    got = grads_to_jax(model, tc)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        bound = GRAD_TOL * max(float(np.abs(w).max()), 1e-30)
        assert g.shape == w.shape, path
        assert float(np.abs(g - w).max()) <= bound, \
            (jax.tree_util.keystr(path), float(np.abs(g - w).max()), bound)
    if tc.moe_every:
        assert plans, "no MoE dispatch"
        dropped = sum(int((~keep).sum()) for _, _, keep, _ in plans)
        assert (dropped > 0) == (arch in OVERRIDES), dropped


@pytest.mark.parametrize("arch", ["xlstm_350m", "seamless_m4t_medium"])
def test_unported_train_routes_raise_naming_the_queue_item(arch):
    """The two routes that once raised here (xLSTM, the encoder-decoder)
    now train: loss and gradients against the reference's at 2 x 16 (the
    encoder-decoder fed seeded frames; ``test_torch_train_recurrent.py``
    runs two chunks and an update)."""
    jc, tc = jcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch)
    jm = j_build(jc)
    params, _ = jm.init_params(jax.random.PRNGKey(0))
    batch = dict(j_pipeline(jc.vocab_size, B, S, seed=1).peek(0))
    if jc.family == "encdec":
        batch["frames"] = np.random.default_rng(1).standard_normal(
            (B, S, jc.d_model)).astype(np.float32)
    want_loss, want = jax.jit(jax.value_and_grad(jm.train_forward))(
        params, batch)
    params_np = jax.tree.map(np.asarray, params)
    model, _ = train_state_from_jax(params_np, _zero_opt(params_np), tc,
                                    "adamw", CPU)
    loss = model.train_forward({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_TOL
    got = grads_to_jax(model, tc)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        w = np.asarray(w)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * max(
            float(np.abs(w).max()), 1e-30)
