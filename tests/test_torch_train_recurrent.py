"""Port: the xLSTM and encoder-decoder train routes against the JAX package.

``Transformer.train_forward`` on xlstm-350m's smoke config (sLSTM and
mLSTM blocks) and ``EncDec.train_forward`` on seamless-m4t-medium's, the
port's model the reference's ``init_params(PRNGKey(0))`` tree converted by
``train_state_from_jax``, fed the same batch (the pipeline's tokens, and
for the encoder-decoder seeded numpy frames ``[B, S, d]``): the loss
within 1e-5 relative of ``jax.value_and_grad`` of the reference's
``train_forward``, each gradient leaf (``grads_to_jax``) within 1e-4 of
its largest magnitude, at 256 tokens, two chunks of the recurrences'
``_pick_chunk``. Then one AdamW step of each side from the reference's
gradients (Adam's first step is ``lr * sign(g)`` where ``g`` is near 0, so
it is compared on equal gradients): every parameter and moment within
1e-5 of its leaf's largest magnitude (the decay rule over the recurrent
and encoder-decoder leaves, the float32 ones included). Both train CLIs refuse seamless's frameless
pipeline batch with the same ``KeyError``; the port's CLI trains xlstm's
smoke config on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.data import make_pipeline as j_pipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.convert import (grads_to_jax,  # noqa: E402
                                 model_params_from_jax, params_to_jax,
                                 train_state_from_jax)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.mamba import _pick_chunk  # noqa: E402

CPU = "cpu"
LOSS_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5
ARCHS = ("xlstm_350m", "seamless_m4t_medium")
B, S = 2, 256
LR = 1e-3


def batch_for(cfg, b: int, s: int, seed: int = 1) -> dict:
    """The pipeline's batch, and for the encoder-decoder seeded frames."""
    batch = dict(j_pipeline(cfg.vocab_size, b, s, seed=seed).peek(0))
    if cfg.family == "encdec":
        rng = np.random.default_rng(seed)
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(params, batch, loss, grads, params and AdamW state after a step),
    numpy."""
    jc = jcfg.get_smoke_config(arch)
    model = j_build(jc)
    params, _ = model.init_params(jax.random.PRNGKey(0))
    batch = batch_for(jc, B, S)
    loss, grads = jax.jit(jax.value_and_grad(model.train_forward))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    init, update = joptim.make_optimizer("adamw", LR)
    state = init(params)
    new, new_state, _ = jax.jit(update)(grads, state, params, 0)
    np_ = lambda t: jax.tree.map(np.asarray, t)
    return (np_(params), batch, float(loss), np_(grads), np_(new),
            np_(state), np_(new_state))


def _close(got, want, tol, what):
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        w = np.asarray(w, np.float32)
        bound = tol * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(g, np.float32) - w).max())
        assert g.shape == w.shape and err <= bound, \
            (what, jax.tree_util.keystr(path), err, bound)


def test_two_chunks():
    assert S // _pick_chunk(S) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_and_adamw_step_match_jax(arch):
    params_np, batch, want_loss, want_g, want_p, st0, want_st = \
        _reference(arch)
    tc = tcfg.get_smoke_config(arch)
    model, opt_state = train_state_from_jax(params_np, st0, tc, "adamw",
                                            CPU)
    loss = model.train_forward({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= LOSS_TOL * abs(
        want_loss)
    _close(grads_to_jax(model, tc), want_g, GRAD_TOL, "grad")
    tree = toptim.param_tree(model)
    grads = toptim.param_tree(model_params_from_jax(want_g, tc, CPU))
    _, update = toptim.make_optimizer("adamw", LR)
    update(grads, opt_state, tree, 0)
    _close(params_to_jax(model), want_p, STEP_TOL, "params")
    _, got_st = grads_to_jax(model, tc, opt_state)
    _close(got_st, {k: want_st[k] for k in ("m", "v")}, STEP_TOL, "moments")


def test_xlstm_f32_leaves_stay_float32_through_a_step():
    """A bf16 xlstm keeps its gate biases and skip in float32."""
    import dataclasses
    from repro_torch.models import build_model
    cfg = dataclasses.replace(tcfg.get_smoke_config("xlstm_350m"),
                              dtype="bfloat16", n_layers=8)
    model = build_model(cfg, device=CPU, seed=0, trainable=True)
    tree = toptim.param_tree(model)
    init, update = toptim.make_optimizer("adamw", LR)
    state = init(tree)
    loss = model.train_forward({k: torch.from_numpy(v) for k, v in
                                batch_for(cfg, 2, 16).items()})
    loss.backward()
    update({k: [p.grad for p in parts] for k, parts in tree.items()},
           state, tree, 0)
    f32 = {k for k, parts in tree.items() if parts[0].dtype == torch.float32}
    assert f32 == {f"period.{pos}.mix.{n}" for pos, n in
                   [(4, "bias")] + [(p, n) for p in (0, 1, 2, 3, 5, 6, 7)
                                    for n in ("f_bias", "i_bias", "skip")]}
    assert np.isfinite(float(loss.detach()))


def test_both_clis_refuse_seamless_pipeline_batches_alike():
    args = ["--arch", "seamless_m4t_medium", "--smoke", "--steps", "1",
            "--global-batch", "2", "--seq-len", "8"]
    with pytest.raises(KeyError, match="frames") as want:
        jtrain.main(args)
    with pytest.raises(KeyError, match="frames") as got:
        ttrain.main(args + ["--device", "cpu"])
    assert got.value.args == want.value.args


def test_port_cli_trains_xlstm_smoke_on_the_cpu():
    res = ttrain.main(["--arch", "xlstm_350m", "--smoke", "--device",
                       "cpu", "--steps", "3", "--global-batch", "2",
                       "--seq-len", "16", "--log-every", "100"])
    assert len(res["history"]) == 3
    assert all(np.isfinite(res["history"]))
