"""Port: the six new families behind the continuous engine and the CLI,
against the reference's.

The continuous engine with ``ModelExecutor`` on xlstm (no attention
layer: the synthetic K/V mirror, keyed by request and position) and on
danube within its window gives the reference engine's integers and emitted
tokens (the reference's parameters converted, its prompts handed over);
danube past its window and the encoder-decoder raise as the reference
does. The batch path is held in ``tests/test_torch_family_serving.py``.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

from test_torch_families import CPU, TOL, _models  # noqa: E402
from test_torch_serving import (MODEL_CFG, TokenLog,  # noqa: E402
                                _assert_engines_agree)


def _engine_pair(arch, **over):
    """The reference engine with its ``ModelExecutor`` on ``arch``'s smoke
    model, and the port's with the converted model on the same prompts."""
    from repro.serving.engine import ServeConfig as JCfg
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.executor import ModelExecutor as JExecutor
    from repro_torch.serving import ModelExecutor, ServeConfig, ServingEngine
    scfg = dict(MODEL_CFG, **over)
    jex = JExecutor(jcfg.get_smoke_config(arch), seed=0)
    jeng = JEngine(JCfg(use_kernel=False, attn_kernel="fused", **scfg),
                   TokenLog(jex))
    prompts = {r.req_id: np.asarray(jex.prompt_tokens(r))
               for r in jeng.queue._pending}
    cfg = tcfg.get_smoke_config(arch)
    tm = model_params_from_jax(jax.tree.map(np.asarray, jex.params), cfg,
                               CPU)
    tex = ModelExecutor(cfg, device=CPU, prompts=prompts, model=tm)
    teng = ServingEngine(ServeConfig(attn_kernel="fused_async", **scfg),
                         TokenLog(tex), device=CPU)
    return jeng, teng


@pytest.mark.parametrize("arch,over", [
    pytest.param("xlstm_350m", {}, id="xlstm-synthetic-mirror"),
    pytest.param("h2o_danube3_4b", dict(prompt_len=5), id="danube-window"),
])
def test_engine_matches_jax(arch, over):
    """The engine's integers exactly and the same emitted tokens, each
    clear of its runner-up by more than the model tolerance. danube's
    requests (prompt <= 5, gen <= 3) fit its window of 8."""
    jeng, teng = _engine_pair(arch, **over)
    jrep, trep = jeng.run(), teng.run()
    _assert_engines_agree(jeng, jrep, teng, trep)
    jlog, tlog = jeng.ex.log, teng.ex.log
    assert len(jlog) == trep["tokens_decoded"] > 0
    assert min(gap for _, _, gap in jlog) > TOL
    assert [(r, t) for r, t, _ in tlog] == [(r, t) for r, t, _ in jlog]


def test_cache_free_mirror_is_keyed_by_request_and_position():
    """xlstm's executor mirrors the synthetic executor's K/V of each
    position (seed + 2), whatever the model computes."""
    from repro_torch.serving import ModelExecutor
    from repro_torch.serving.executor import synth_kv
    from repro_torch.serving.request import PREFILL, Request
    _, _, tm = _models("xlstm_350m")
    ex = ModelExecutor(tcfg.get_smoke_config("xlstm_350m"), seed=4,
                       device=CPU, model=tm)
    assert ex.kv_layer is None
    req = Request(3, prompt_len=5, gen=2)
    req.to(PREFILL, 0)
    ex.begin(req)
    k, v, tok = ex.prefill_chunk(req, 5)
    wk, wv = synth_kv(6, 3, 0, 5, 4, 16, torch.float32, CPU)
    assert torch.equal(k, wk) and torch.equal(v, wv) and tok is not None


def test_window_and_encdec_refusals_match_the_reference():
    """danube past its window: both executors refuse the request in
    ``begin``; the encoder-decoder: both refuse the model."""
    from repro.serving.executor import ModelExecutor as JExecutor
    from repro_torch.serving import ModelExecutor
    jeng, teng = _engine_pair("h2o_danube3_4b", prompt_len=8)
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="sliding-window cache"):
            eng.run()
    with pytest.raises(ValueError, match="encdec serving stays on the "
                                         "batch driver"):
        JExecutor(jcfg.get_smoke_config("seamless_m4t_medium"))
    with pytest.raises(ValueError, match="encdec serving stays on the "
                                         "batch driver"):
        ModelExecutor(tcfg.get_smoke_config("seamless_m4t_medium"),
                      device=CPU)


@pytest.mark.parametrize("arch", ["xlstm_350m", "qwen2_vl_72b"])
def test_cli_engine_serves_on_cpu(arch):
    res = tserve.main(["--arch", arch, "--smoke", "--device", CPU,
                       "--arrival", "bursty", "--paged", "--async-datapath",
                       "--attn-kernel", "fused-async", "--page-size", "4",
                       "--prompt-len", "8", "--gen", "3", "--batch", "2",
                       "--requests", "3", "--prefill-chunk", "4"])
    assert res["tiered_equiv_ok"] and res["requests_finished"] == 3
