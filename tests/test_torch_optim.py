"""Port: the optimizers, schedules and clipping against ``repro.optim``.

AdamW and Adafactor take four steps on the period-stacked smoke trees of
qwen2.5-3b (two periods, QKV biases), stablelm-12b (LayerNorm: a 1-D
final bias) and llama4-maverick (MoE experts: rank-4 stacked leaves), the
port's state carried across by ``train_state_from_jax`` and brought back
by ``grads_to_jax``: parameters and optimizer state within 1e-6 of each
leaf's largest magnitude of the reference's after every step, with the
same gradients (numpy normals from a seed) each step. The rank rule is the
reference's: per-layer norm scales and biases are decayed and factored
(they are ``[n_periods, d]`` leaves there), ``final_norm`` is not. The
schedules within 1e-7 relative, ``clip_by_global_norm`` too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.convert import (grads_to_jax,  # noqa: E402
                                 model_params_from_jax, params_to_jax,
                                 train_state_from_jax)
from repro_torch.optim.common import leaf_ndim  # noqa: E402

CPU = "cpu"
TOL, SCHED_TOL = 1e-6, 1e-7
ARCHS = ("qwen2_5_3b", "stablelm_12b", "llama4_maverick_400b")
N_STEPS = 4


def _reference_tree(arch):
    params, _ = j_build(jcfg.get_smoke_config(arch)).init_params(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _grads(params_np, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(a.dtype),
        params_np)


def _port_grads(grads_np, cfg):
    """The reference's gradient tree as a port parameter tree."""
    return toptim.param_tree(model_params_from_jax(grads_np, cfg, CPU))


def _close_trees(got, want, what):
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        bound = TOL * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(g) - np.asarray(w)).max())
        assert err <= bound, (what, jax.tree_util.keystr(path), err, bound)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_steps_match_the_reference(arch, opt_name):
    lr = joptim.cosine_warmup(1e-2, 2, N_STEPS)
    j_init, j_update = joptim.make_optimizer(opt_name, lr)
    j_update = jax.jit(j_update)
    t_init, t_update = toptim.make_optimizer(
        opt_name, toptim.cosine_warmup(1e-2, 2, N_STEPS))
    cfg = tcfg.get_smoke_config(arch)
    params_np = _reference_tree(arch)
    params = jax.tree.map(jnp.asarray, params_np)
    state = j_init(params)
    model, t_state = train_state_from_jax(
        params_np, jax.tree.map(np.asarray, state), cfg, opt_name, CPU)
    tree = toptim.param_tree(model)
    for step in range(N_STEPS):
        grads_np = _grads(params_np, step)
        params, state, info = j_update(jax.tree.map(jnp.asarray, grads_np),
                                       state, params, jnp.int32(step))
        _, _, t_info = t_update(_port_grads(grads_np, cfg), t_state, tree,
                                step)
        assert abs(float(t_info["grad_norm"]) - float(info["grad_norm"])) \
            <= TOL * float(info["grad_norm"])
        _close_trees(params_to_jax(model), jax.tree.map(np.asarray, params),
                     f"params, step {step}")
        _, opt = grads_to_jax(model, cfg, t_state)
        _close_trees(opt, jax.tree.map(np.asarray, state),
                     f"{opt_name} state, step {step}")


def test_the_rank_rule_is_the_reference_leaf_rank():
    cfg = tcfg.get_smoke_config("stablelm_12b")
    tree = toptim.param_tree(
        model_params_from_jax(_reference_tree("stablelm_12b"), cfg, CPU))
    ranks = {k: leaf_ndim(k, parts) for k, parts in tree.items()}
    assert ranks["period.0.norm1.scale"] == ranks["period.0.norm1.bias"] == 2
    assert ranks["period.0.mix.wq"] == 3
    assert ranks["final_norm.scale"] == ranks["final_norm.bias"] == 1
    assert ranks["embed"] == 2
    assert len(tree["period.0.norm1.scale"]) == cfg.n_layers


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 10, 50), (1e-2, 1, 7),
                                               (0.7, 0, 1), (1e-3, 5, 5)])
def test_schedules_match_the_reference(peak, warmup, total):
    pairs = [(joptim.linear_warmup(peak, warmup),
              toptim.linear_warmup(peak, warmup)),
             (joptim.cosine_warmup(peak, warmup, total),
              toptim.cosine_warmup(peak, warmup, total)),
             (joptim.cosine_warmup(peak, warmup, total, floor=0.0),
              toptim.cosine_warmup(peak, warmup, total, floor=0.0))]
    for jlr, tlr in pairs:
        for step in range(total + 12):
            want = float(jlr(jnp.int32(step)))
            got = tlr(step)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= SCHED_TOL * abs(want), step


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e6])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    cfg = tcfg.get_smoke_config("qwen2_5_3b")
    grads_np = _grads(_reference_tree("qwen2_5_3b"), 7)
    want, norm = joptim.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads_np), max_norm)
    tree = _port_grads(grads_np, cfg)
    got_norm = toptim.global_norm(tree)
    _, got_norm2 = toptim.clip_by_global_norm(tree, max_norm)
    assert float(got_norm) == float(got_norm2)
    assert abs(float(got_norm) - float(norm)) <= SCHED_TOL * float(norm)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    got = {k: np.stack([t.numpy() for t in parts]) if k.startswith("period")
           else parts[0].numpy() for k, parts in tree.items()}
    for path, w in paths:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        w = np.asarray(w)
        err = float(np.abs(got[key] - w).max())
        assert err <= SCHED_TOL * float(np.abs(w).max()), (key, err)
