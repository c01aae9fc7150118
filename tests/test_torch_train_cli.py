"""Port: the trainer CLI (``repro_torch.launch.train``) against the
reference's (``repro.launch.train``), on the CPU.

Its flags diffed against the reference's (and the depth cut refused off
the scan period); 12 smoke steps within 1e-4 relative of the reference
``train.main``'s from the same initial state (the reference's
``init_params(PRNGKey(0))`` and zero moments, written as the port's
step-0 checkpoint, which its ``main`` restores); a kill and restart
bitwise equal to an uninterrupted run; and a reference checkpoint after 4
steps carried across by ``train_state_from_jax`` and continued 4 steps
within 1e-4 of the reference's own continuation; a rerun over a finished
run's checkpoints runs no step.
"""

import argparse

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.checkpoint import restore_checkpoint as j_restore  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.optim import make_optimizer as j_optimizer  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

CPU = "cpu"
CLI_TOL = 1e-4
CLI = ["--arch", "qwen2_5_3b", "--smoke", "--global-batch", "4",
       "--seq-len", "16", "--log-every", "100"]


def _zero_opt(params_np):
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), params_np)
    return {"m": zeros, "v": zeros}


def _ref_parser(monkeypatch):
    """The reference CLI's parser, caught as ``main`` parses."""
    box = {}

    class Caught(Exception):
        pass

    def catch(self, *a, **kw):
        box["ap"] = self
        raise Caught

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(Caught):
            jtrain.main([])
    return box["ap"]


def test_cli_flags_match_the_reference_cli(monkeypatch, capsys):
    opts = lambda ap: {a.option_strings[0]: (a.dest, a.default, a.type)
                       for a in ap._actions
                       if a.option_strings and a.dest != "help"}
    want, got = opts(_ref_parser(monkeypatch)), opts(ttrain.build_parser())
    assert len(want) == 10
    assert set(got) - set(want) == {"--device", "--layers"}
    assert {f: got[f] for f in want} == want
    with pytest.raises(SystemExit) as e:     # jamba's period is 8
        ttrain.main(["--arch", "jamba_v01_52b", "--smoke", "--layers", "4",
                     "--device", CPU])
    assert e.value.code == 2
    assert "multiple of" in capsys.readouterr().err


def _seed_port_checkpoint(directory, step, params_np, opt_np):
    """The reference's state of ``step`` as the port's checkpoint."""
    cfg = tcfg.get_smoke_config("qwen2_5_3b")
    model, opt = train_state_from_jax(params_np, opt_np, cfg, "adamw", CPU)
    save_checkpoint(str(directory), step,
                    {"params": model.state_dict(), "opt": opt},
                    {"data_step": step})


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def test_cli_smoke_losses_match_the_reference_main(tmp_path):
    want = jtrain.main(CLI + ["--steps", "12"])["history"]
    # the reference's initial state (its init_params(PRNGKey(0)), zero
    # moments) as the port's step-0 checkpoint, which its main restores
    params, _ = j_build(jcfg.get_smoke_config("qwen2_5_3b")).init_params(
        jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, params)
    _seed_port_checkpoint(tmp_path, 0, params_np, _zero_opt(params_np))
    got = ttrain.main(CLI + ["--steps", "12", "--device", CPU,
                             "--ckpt-dir", str(tmp_path),
                             "--save-every", "4"])
    assert len(got["history"]) == 12 and got["monitor"]["steps"] == 12
    assert _rel(got["history"], want) <= CLI_TOL
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000008", "step_00000012"]


def test_cli_kill_and_restart_is_bitwise(tmp_path, monkeypatch):
    args = CLI + ["--steps", "12", "--device", CPU]
    clean = ttrain.main(args)["history"]
    fail = {6: True}
    make = ttrain.make_pipeline

    def failing_pipeline(*a, **kw):
        pipe = make(*a, **kw)
        peek = pipe.peek

        def once(step):
            if fail.pop(step, False):
                raise RuntimeError("simulated preemption")
            return peek(step)

        pipe.peek = once
        return pipe

    monkeypatch.setattr(ttrain, "make_pipeline", failing_pipeline)
    got = ttrain.main(args + ["--ckpt-dir", str(tmp_path),
                              "--save-every", "4"])["history"]
    # steps 0-5, the failure at 6, then 4-11 again from the step-4 save
    assert got == clean[:6] + clean[4:]


def test_cli_continues_a_reference_state(tmp_path):
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    want = jtrain.main(CLI + ["--steps", "8", "--ckpt-dir", str(ref_dir),
                              "--save-every", "4"])["history"]
    model = j_build(jcfg.get_smoke_config("qwen2_5_3b"))
    params, _ = model.init_params(jax.random.PRNGKey(0))
    opt_init, _ = j_optimizer("adamw", 1e-3)
    like = {"params": params, "opt": opt_init(params)}
    state, extras = j_restore(str(ref_dir), 4, like)
    assert extras == {"data_step": 4}
    state = jax.tree.map(np.asarray, state)
    _seed_port_checkpoint(port_dir, 4, state["params"], state["opt"])
    got = ttrain.main(CLI + ["--steps", "8", "--device", CPU, "--ckpt-dir",
                             str(port_dir), "--save-every", "4"])
    assert len(got["history"]) == 4
    assert _rel(got["history"], want[4:]) <= CLI_TOL


def test_cli_rerun_of_a_finished_directory(tmp_path):
    """A rerun with the ``--ckpt-dir`` of a finished run restores its last
    checkpoint, step ``--steps``, and runs no step: no loss. A checkpoint
    of another model (here one layer against two) is refused."""
    args = CLI + ["--steps", "4", "--device", CPU, "--ckpt-dir",
                  str(tmp_path), "--save-every", "4"]
    assert len(ttrain.main(args)["history"]) == 4
    again = ttrain.main(args)
    assert again["history"] == [] and again["final_loss"] is None
    with pytest.raises(ValueError, match="leaves"):
        ttrain.main(args + ["--layers", "1"])
