"""Port: the MoE family's serving paths against the reference's.

llama4-maverick's smoke model behind ``ModelExecutor`` in the continuous
engine gives the reference engine's integers and emitted tokens; the CLI
serves both archs, depth cut by ``--layers``, on the batch path and the
continuous engine with ``--device cpu``, and exits 0. (The models, and
phi's batch path, are held in ``tests/test_torch_moe_family.py``.)
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

from test_torch_moe_family import CPU, TOL  # noqa: E402
from test_torch_serving import (MODEL_CFG, TokenLog,  # noqa: E402
                                _assert_engines_agree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def llama4_jax_run():
    """The reference engine on llama4's smoke model behind its executor
    (``attn_kernel="fused"``: its async Pallas kernel does not run on this
    JAX, and the integers do not depend on the mode)."""
    from repro.serving.engine import ServeConfig as JCfg
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.executor import ModelExecutor as JExecutor
    jex = JExecutor(jcfg.get_smoke_config("llama4_maverick_400b"), seed=0)
    jeng = JEngine(JCfg(use_kernel=False, attn_kernel="fused", **MODEL_CFG),
                   TokenLog(jex))
    prompts = {r.req_id: np.asarray(jex.prompt_tokens(r))
               for r in jeng.queue._pending}
    jrep = jeng.run()
    return jex, jeng, jrep, prompts


@pytest.mark.parametrize("mode", ["fused", "fused_async"])
def test_llama4_engine_matches_jax(llama4_jax_run, mode):
    """llama4's smoke model (a dense layer, then a MoE layer with the shared
    expert) behind ``ModelExecutor`` in the continuous engine, against the
    reference engine with its executor: the integers exactly and the same
    emitted tokens, each leading its runner-up by more than the model
    tolerance."""
    from repro_torch.serving import ModelExecutor, ServeConfig, ServingEngine
    jex, jeng, jrep, prompts = llama4_jax_run
    cfg = tcfg.get_smoke_config("llama4_maverick_400b")
    tm = model_params_from_jax(jax.tree.map(np.asarray, jex.params), cfg,
                               CPU)
    tex = ModelExecutor(cfg, device=CPU, prompts=prompts, model=tm)
    teng = ServingEngine(ServeConfig(attn_kernel=mode, **MODEL_CFG),
                         TokenLog(tex), device=CPU)
    trep = teng.run()
    _assert_engines_agree(jeng, jrep, teng, trep)
    jlog, tlog = jeng.ex.log, teng.ex.log
    assert len(jlog) == trep["tokens_decoded"] > 0
    assert min(gap for _, _, gap in jlog) > TOL
    assert [(r, t) for r, t, _ in tlog] == [(r, t) for r, t, _ in jlog]


def _cli_argv(arch, layers, arrival):
    return ["--arch", arch, "--smoke", "--layers", str(layers), "--device",
            CPU, "--arrival", arrival, "--paged", "--async-datapath",
            "--attn-kernel", "fused-async", "--page-size", "4",
            "--prompt-len", "8", "--gen", "3", "--batch", "2",
            "--requests", "3", "--prefill-chunk", "4"]


@pytest.mark.parametrize("arch,layers", [("phi35_moe_42b", 1),
                                         ("llama4_maverick_400b", 2)])
@pytest.mark.parametrize("arrival", ["batch", "bursty"])
def test_cli_serves_on_cpu(arch, layers, arrival):
    """Both archs, depth cut by ``--layers``, on the batch path and the
    continuous engine, through the CLI's ``main`` (which raises
    ``SystemExit`` where the process would exit non-zero)."""
    res = tserve.main(_cli_argv(arch, layers, arrival))
    assert res["tiered_equiv_ok"]
    if arrival == "bursty":
        assert res["requests_finished"] == 3


def test_cli_process_exits_zero_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *_cli_argv("llama4_maverick_400b", 2, "bursty")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "'tiered_equiv_ok': True" in res.stdout
