"""Port: imports stand alone (no JAX, nothing of ``repro``), and entry points
never fall back to the CPU by themselves."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules() -> list[str]:
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    for m in ("repro_torch.serving.engine", "repro_torch.models.transformer",
              "repro_torch.configs.qwen2_5_3b", "repro_torch.obs.export"):
        assert m in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
            "sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(str(p) for p in PORT.rglob("*.py"))
                         + [str(ROOT / "chip_smoke.py")])
def test_no_import_of_jax_or_the_reference(path):
    tree = ast.parse(pathlib.Path(path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("repro", "jax", "jaxlib"), f"{path}: {n}"


def test_entry_points_without_gpu_raise_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.device import resolve_device
    from repro_torch.paging.tiered_kv import TieredKV, tiered_init
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.serving.executor import SyntheticExecutor
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticExecutor(2, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiered_init(TieredKV(8, 8, 4, 2, 8), 2)
    ex = SyntheticExecutor(2, 8, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(ServeConfig(), ex)
    assert resolve_device("cpu").type == "cpu"
    ServingEngine(ServeConfig(), ex, device="cpu")


def test_model_entry_points_without_gpu_raise_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serving import ModelExecutor, build_executor
    cfg = configs.get_smoke_config("qwen2_5_3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelExecutor(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_executor("qwen2_5_3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    ex = build_executor("qwen2_5_3b", device="cpu")
    assert isinstance(ex, ModelExecutor) and ex.device.type == "cpu"


def test_cli_without_gpu_fails_and_chip_smoke_refuses_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU failure cannot be shown")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for extra in (["--synthetic"], ["--smoke"]):
        res = subprocess.run([sys.executable, "-m",
                              "repro_torch.launch.serve", "--requests", "1",
                              *extra], env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode != 0 and "device='cpu'" in res.stderr
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """``chip_smoke.py`` in a directory with nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
