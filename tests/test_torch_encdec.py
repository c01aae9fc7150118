"""Port: the encoder-decoder against ``repro.models.encdec``.

The reference's ``init_params(PRNGKey(0))`` tree of a small LayerNorm /
GELU encoder-decoder (f32, GQA and QKV bias switched on beside the smoke
config's MHA) converted with ``model_params_from_jax``; the same frames
and tokens from a numpy seed. ``encode``, the prefill's logits and its
self / cross K/V, and decode steps are held at 1e-4. The cross K/V stay
those of the prefill through decode.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.models import EncDec, build_model  # noqa: E402

TOL = 1e-4
CPU = "cpu"
CFGS = {"smoke": {}, "gqa_bias": dict(n_kv_heads=2, qkv_bias=True)}


@functools.lru_cache(maxsize=None)
def _models(name):
    over = CFGS[name]
    jc = dataclasses.replace(jcfg.get_smoke_config("seamless_m4t_medium"),
                             **over)
    tc = dataclasses.replace(tcfg.get_smoke_config("seamless_m4t_medium"),
                             **over)
    params, _ = jed.init_params(jax.random.PRNGKey(0), jc)
    tm = model_params_from_jax(jax.tree.map(np.asarray, params), tc, CPU)
    return jc, params, tm


def _data(seed, se=9, sd=7):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((2, se, 64)).astype(np.float32)
    toks = rng.integers(0, 512, (2, sd + 3)).astype(np.int32)
    return frames, toks


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_build_model_dispatches_encdec():
    m = build_model(tcfg.get_smoke_config("seamless_m4t_medium"),
                    device=CPU, seed=0)
    assert isinstance(m, EncDec)
    names = dict(m.named_parameters())
    assert "dec.1.self.wq" in names and "enc.0.norm1.bias" in names
    assert m.lm_head().shape == (64, 512)


@pytest.mark.parametrize("name", list(CFGS))
def test_encode_matches_jax(name):
    jc, params, tm = _models(name)
    frames, _ = _data(1)
    want = jed.encode(params, jc, jnp.asarray(frames))
    got = tm.encode(torch.from_numpy(frames))
    _close(got, want)


@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_and_decode_match_jax(name):
    jc, params, tm = _models(name)
    frames, toks = _data(2)
    sd = toks.shape[1] - 3
    jlog, jst = jed.prefill(params, jc, jnp.asarray(frames),
                            jnp.asarray(toks[:, :sd]), 12)
    tlog, tst = tm.prefill(torch.from_numpy(toks[:, :sd]), 12,
                           torch.from_numpy(frames))
    _close(tlog, jlog)
    for part in ("self_kv", "cross_kv"):
        for k in ("k", "v"):
            assert tst[part][k].shape == jst[part][k].shape
            _close(tst[part][k], jst[part][k])
    cross = {k: tst["cross_kv"][k].clone() for k in ("k", "v")}
    for t in range(sd, sd + 3):
        jlog, jst = jed.decode_step(params, jc, jnp.asarray(toks[:, t]), jst)
        tlog, tst = tm.decode_step(torch.from_numpy(toks[:, t]), tst)
        _close(tlog, jlog)
    assert tst["pos"] == int(jst["pos"]) == sd + 3
    _close(tst["self_kv"]["k"], jst["self_kv"]["k"])
    assert all(torch.equal(tst["cross_kv"][k], cross[k]) for k in cross)


def test_padded_vocab_logits():
    """seamless pads its vocabulary by 50 rows: the logits cover all of
    them, as the reference's."""
    cfg = tcfg.get_config("seamless_m4t_medium")
    assert cfg.padded_vocab == 256256
    small = dataclasses.replace(tcfg.get_smoke_config("seamless_m4t_medium"),
                                vocab_pad=50)
    m = build_model(small, device=CPU, seed=0)
    frames, toks = _data(3)
    logits, _ = m.prefill(torch.from_numpy(toks[:, :4]), 8,
                          torch.from_numpy(frames))
    assert logits.shape == (2, 562)


def test_batch_path_matches_the_reference_cli(tmp_path):
    """``_main_batch`` on the smoke model (its frames drawn as the
    reference CLI draws them) against the reference CLI: report integers,
    event log and greedy tokens (``tests/test_torch_family_serving.py``)."""
    from test_torch_family_serving import check_batch_path
    check_batch_path("seamless_m4t_medium", tmp_path)
