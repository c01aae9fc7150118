"""Port: the six new families behind the batch path, against the
reference's.

``_main_batch`` with the paged replay on each smoke model (the reference's
parameters converted, its prompts and, for the encoder-decoder, its frames
handed over) gives the reference CLI's report integers and sweep event
log, and the reference CLI's greedy tokens, token for token (the CLI
reports only their shape, so they are drawn here as it draws them). A
token may differ only where the reference's own top two logits lie within
:data:`TIE` of each other, the f32 error between the two models; that
row is not compared past it. Past danube's window the batch path mirrors
the rolled buffer as the reference does. The continuous engine is held in
``tests/test_torch_family_engine.py``; :func:`check_batch_path` also
serves the encoder-decoder and xlstm in their own test files.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

from test_torch_families import ARCHS, CPU, _models  # noqa: E402

B, P, G = 2, 16, 4
REPORT = ("tokens_shape", "tiered_equiv_ok", "tiered_streams",
          "tiered_n_slots", "tiered_hot_frac", "paged_prefetch_hit_rate",
          "paged_pollution", "paged_ring_drops", "trace_events",
          "trace_totals_ok")


#: a top-two logit gap the port's f32 error (about 1e-5 against the
#: reference) could flip: only there may a greedy token differ
TIE = 1e-4


def _reference_greedy(arch, prompts, frames):
    """The reference CLI's greedy decode of ``G`` tokens on ``prompts`` /
    ``frames`` (its ``PRNGKey(0)`` parameters, ``prefill`` then the
    jitted ``decode_step``) -> (tokens ``[B, G]``, each step's gap between
    the top two logits ``[B, G]``)."""
    model, params, _ = _models(arch)
    batch = {"tokens": jnp.asarray(prompts)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    logits, st = model.prefill(params, batch, P + G)
    step = jax.jit(model.decode_step)
    toks, gaps = [], []
    for t in range(G):
        if t:
            logits, st = step(params, jnp.asarray(toks[-1]), st)
        lg = np.asarray(logits)
        top2 = np.sort(lg, -1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        toks.append(lg.argmax(-1).astype(np.int32))
    return np.stack(toks, 1), np.stack(gaps, 1)


def _assert_same_greedy(got, want, gaps):
    """``got == want`` token for token, but where a row first differs the
    reference's top two logits must be within :data:`TIE` (that row is
    not compared past it: the two decodes went on from different
    tokens)."""
    for b in range(len(want)):
        bad = np.flatnonzero(got[b] != want[b])
        if bad.size:
            t = bad[0]
            assert gaps[b, t] < TIE, (
                f"row {b}: token {t} is {got[b, t]}, the reference's "
                f"{want[b, t]} leads by {gaps[b, t]:.3g}")


def check_batch_path(arch, tmp_path):
    """``_main_batch`` on ``arch``'s smoke model against the reference
    CLI's, on the sync data path (the reference's async gather kernel does
    not run on this JAX; the sweep integers do not depend on the attention
    mode, so the port serves through its fused kernel)."""
    import repro.launch.serve as jserve
    cfg = jcfg.get_smoke_config(arch)
    _, _, tm = _models(arch)
    argv = ["--arch", arch, "--smoke", "--batch", str(B), "--prompt-len",
            str(P), "--gen", str(G), "--page-size", "4", "--paged",
            "--chunk", "2", "--ring-size", "4"]
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = jserve._main_batch(jserve.build_parser().parse_args(
        argv + ["--trace", jpath]))
    # the reference CLI's inputs, drawn as its _main_batch draws them
    rng = jax.random.PRNGKey(1)
    prompts = np.asarray(jax.random.randint(rng, (B, P), 0,
                                            cfg.vocab_size))
    frames = (np.asarray(jax.random.normal(rng, (B, P, cfg.d_model)))
              if cfg.family == "encdec" else None)
    got = tserve._main_batch(tserve.build_parser().parse_args(
        argv + ["--device", CPU, "--trace", tpath, "--attn-kernel",
                "fused"]), model=tm, prompts=prompts, frames=frames)
    tokens = np.asarray(got["tokens"])
    assert tokens.shape == (B, G)
    _assert_same_greedy(tokens, *_reference_greedy(arch, prompts, frames))
    for key in REPORT:
        assert got[key] == want[key], key
    assert got["tiered_equiv_ok"] and got["trace_totals_ok"]
    read = lambda p: [json.loads(line) for line in
                      pathlib.Path(p + ".jsonl").read_text().splitlines()]
    assert read(tpath) == read(jpath)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in (
    "seamless_m4t_medium", "xlstm_350m")])
def test_batch_path_matches_the_reference_cli(arch, tmp_path):
    """The four decoder-only attention families (the encoder-decoder's and
    xlstm's batch paths are held in ``tests/test_torch_encdec.py`` and
    ``tests/test_torch_xlstm.py``, to spread the files' time)."""
    check_batch_path(arch, tmp_path)


def test_batch_mirror_past_the_window_is_the_rolled_buffer():
    """danube's smoke window (8) under a 16-token prompt: the mirrored
    K/V are the rolling buffer's 8 slots, zero beyond, as the
    reference's ``find_dense_kv`` + ``pad_to``."""
    from repro_torch.serving.batch_driver import find_dense_kv
    _, _, tm = _models("h2o_danube3_4b")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (B, P)))
    _, st = tm.prefill(toks, P + G)
    k, v = find_dense_kv(st)
    assert k.shape == (B, 8, 2, 16) and k is st["blocks"][0]["k"]
