"""Port: the sharding layer and the gradient codec against the JAX package.

* **Sharding resolution.** All ten configs at their published widths,
  the port built on the ``meta`` device and the reference through
  ``jax.eval_shape``: every parameter leaf's PartitionSpec parts from the
  port's ``named_sharding_for`` equal the reference's on the fake meshes
  of ``tests/test_configs_sharding.py`` (data 16, model 16, pod 2),
  under the train and serve rules, one pod and many, with
  ``arch_rule_overrides``; the reference stacks a per-layer leaf under a
  leading ``"layers"``, which resolves to ``None``. The same for
  ``opt_state_shardings`` (AdamW and Adafactor), ``batch_shardings``
  (``positions3`` batched on dim 1) and ``kv_pool_specs``; the five
  ``TestShardingResolution`` cases, ported.
* **Meshes.** ``make_production_mesh`` at world sizes 256 and 512 under
  the fake process group, in this process; ``make_fabric_mesh`` raises
  when the world is smaller than its shards.
* **The codec.** ``compress_int8`` / ``decompress_int8`` /
  ``init_error_feedback`` bitwise against ``repro.runtime.compression``,
  and the reference's error-feedback test, ported.
* **Four gloo ranks**, spawned once for the file from a ``FileStore``
  under ``tmp_path``, run every multi-rank case and write their results:
  ``compressed_psum`` against the reference's under ``jax.vmap(...,
  axis_name=...)`` over four stacked workers (``q`` and the new errors
  bitwise, the mean within 1e-6 relative); ``make_sharded_train_step`` on
  a (2, 2) data x model mesh, qwen2.5-3b's smoke config under
  ``RULES_TRAIN`` and xlstm's under its pure-DP override, against the
  single-process step (and qwen2.5-3b's with Adafactor): the loss within
  1e-6 relative, every gradient within 1e-5 of its leaf's largest
  magnitude, and every updated parameter and AdamW moment (Adafactor
  accumulator) within 1e-5 of its leaf's largest magnitude
  after the single-process update of the same gradients (AdamW's first
  step maps a gradient element within about its eps of zero to +-lr, so
  a rounding-level difference there moves a parameter by up to 2 lr:
  the update is held on equal gradients); a two-axis part's placements
  against the reference's ``NamedSharding`` layout (major to minor);
  ``restore_checkpoint(shardings=)`` round-tripping a placed tree.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import build_model as j_build  # noqa: E402
from repro.paging import kv_cache as jkv  # noqa: E402
from repro.runtime import compression as jcomp  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import _ref_get  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.optim import param_tree  # noqa: E402
from repro_torch.paging import kv_cache as tkv  # noqa: E402
from repro_torch.runtime import compression as tcomp  # noqa: E402

WORLD = 4
LOSS_TOL, GRAD_TOL, STEP_TOL, MEAN_TOL = 1e-6, 1e-5, 1e-5, 1e-6
STEP_ARCHS = ("qwen2_5_3b", "xlstm_350m")
B, S, LR = 4, 16, 1e-4


class FakeMesh:
    shape = {"data": 16, "model": 16, "pod": 2}


class OnePod:
    shape = {"data": 16, "model": 16}


def _ref_parts(monkeypatch, fn, *args):
    """The reference's PartitionSpec parts: ``fn`` run with its
    NamedSharding captured (as ``TestShardingResolution`` does)."""
    monkeypatch.setattr(jsh, "NamedSharding",
                        lambda mesh, spec: tuple(spec))
    return fn(*args)


def _rules(mode, multi_pod, arch=None):
    r = tsh.rules_for(mode, multi_pod)
    if arch:
        r.update(tsteps.arch_rule_overrides(arch, mode, multi_pod))
    return r


# --------------------------------------------------------------------------
# resolution
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_specs(arch):
    model = j_build(jcfg.get_config(arch))
    box = {}

    def f(k):
        p, s = model.init_params(k)
        box["s"] = s
        return p

    shapes = jax.eval_shape(f, jax.random.PRNGKey(0))
    return shapes, box["s"]


@pytest.mark.parametrize("arch", tcfg.ARCHS)
def test_every_leaf_resolves_to_the_reference_parts(arch, monkeypatch):
    shapes, specs = _jax_specs(arch)
    model = t_build(tcfg.get_config(arch), device="meta", seed=None)
    axes = model.param_specs()
    assert list(axes) == [n for n, _ in model.named_parameters()]
    tspecs, tshapes = tsteps.tree_specs(model)
    P = model.cfg.scan_period()
    names = {}
    for name in axes:
        names.setdefault(tsteps.tree_key(name, P)[0], []).append(name)
    n = 0
    for mode in ("train", "serve"):
        for mesh, multi in ((OnePod, False), (FakeMesh, True)):
            rules = {**jsh.rules_for(mode, multi),
                     **jsteps.arch_rule_overrides(arch, mode, multi)}
            assert rules == _rules(mode, multi, arch)
            for key, parts in param_tree(model).items():
                ax, shape = _ref_get(specs, key), _ref_get(shapes, key).shape
                assert tspecs[key] == tuple(ax) and tshapes[key] == shape
                want = _ref_parts(monkeypatch, jsh.named_sharding_for, ax,
                                  shape, mesh(), rules)
                stacked = ax[0] == "layers"
                if stacked:
                    assert want[0] is None
                for name, p in zip(names[key], parts):
                    got = tsh.named_sharding_for(axes[name], tuple(p.shape),
                                                 mesh(), rules)
                    assert got == (want[1:] if stacked else want), \
                        (mode, multi, key)
                    n += 1
    assert n == 4 * len(axes)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "llama4_maverick_400b",
                                  "seamless_m4t_medium", "xlstm_350m"])
def test_opt_state_shardings_match_the_reference(arch, opt_name,
                                                 monkeypatch):
    shapes, specs = _jax_specs(arch)
    model = t_build(tcfg.get_config(arch), device="meta", seed=None)
    pspecs, pshapes = tsteps.tree_specs(model)
    rules = _rules("train", True, arch)
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: tuple(spec))
    want = jsteps.opt_state_shardings(opt_name, specs, shapes, FakeMesh(),
                                      rules)
    got = tsteps.opt_state_shardings(opt_name, pspecs, pshapes, FakeMesh(),
                                     rules)
    for key in pspecs:
        if opt_name == "adamw":
            for n in ("m", "v"):
                assert got[n][key] == _ref_get(want[n], key), key
        else:
            assert got["acc"][key] == _ref_get(want["acc"], key), key


def test_batch_and_kv_pool_shardings_match_the_reference(monkeypatch):
    cfg = jcfg.get_config("qwen2_vl_72b")
    batch = jcfg.train_batch_specs(cfg, 32, 4096)
    tb = {k: tuple(v.shape) for k, v in batch.items()}
    assert set(tb) == {"tokens", "targets", "mask", "embeds", "positions3"}
    for multi, mesh in ((False, OnePod), (True, FakeMesh)):
        rules = _rules("train", multi)
        want = _ref_parts(monkeypatch, jsh.batch_shardings, batch, mesh(),
                          rules)
        assert tsh.batch_shardings(tb, mesh(), rules) == want
        assert want["positions3"][1] is not None
    assert tkv.kv_pool_specs(7) == jkv.kv_pool_specs(7)
    rules = _rules("serve", False)
    class Fabric:
        shape = {"fabric": 4, "data": 2}

    for name, mesh in (("fabric", Fabric), ("data", OnePod)):
        parts = tsh.named_sharding_for(tkv.kv_pool_specs(2)["k"],
                                       (2, 64, 16, 8, 128), mesh(), rules)
        assert parts == (None, name, None, None, None)


class TestShardingResolution:
    """The reference's five cases, on the port's resolution."""

    def _parts(self, axes, shape, rules):
        return tsh.named_sharding_for(axes, shape, FakeMesh(), rules)

    def test_basic_tp_fsdp(self):
        rules = tsh.rules_for("train", False)
        assert self._parts(("embed", "ff"), (8192, 29568), rules) == \
            ("data", "model")

    def test_divisibility_fallback(self):
        rules = tsh.rules_for("train", False)
        assert self._parts(("embed", "vocab"), (1024, 256206), rules) == \
            ("data", None)

    def test_duplicate_axis_dropped(self):
        rules = tsh.rules_for("train", False)
        assert self._parts(("experts", "ff"), (128, 6400), rules) == \
            ("model", None)

    def test_batch_of_one_replicates(self):
        rules = tsh.rules_for("serve", False)
        assert self._parts(("layers", "batch", "kv_seq"), (4, 1, 524288),
                           rules) == (None, None, "model")

    def test_multipod_batch_axes(self):
        rules = tsh.rules_for("train", True)
        assert self._parts(("batch",), (256,), rules) == (("pod", "data"),)


def test_rules_tables_are_the_reference_s():
    assert tsh.RULES_TRAIN == jsh.RULES_TRAIN
    assert tsh.RULES_SERVE == jsh.RULES_SERVE
    for mode in ("train", "serve"):
        for multi in (False, True):
            assert tsh.rules_for(mode, multi) == jsh.rules_for(mode, multi)


# --------------------------------------------------------------------------
# meshes under the fake process group
# --------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod,world", [(False, 256), (True, 512)])
def test_production_mesh_under_the_fake_process_group(multi_pod, world):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_fabric_mesh, make_production_mesh
    from repro_torch.distributed.sharding import placements_for
    from torch.distributed.tensor import Replicate, Shard

    dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                            world_size=world)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        assert mesh.mesh_dim_names == names
        assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16))
        assert list(mesh.get_coordinate()) == [s - 1 for s in mesh.shape]
        batch = tsh.rules_for("train", multi_pod)["batch"]
        got = placements_for(tsh.named_sharding_for(("batch", "embed"),
                                                    (world, 1024), mesh,
                                                    tsh.RULES_TRAIN), mesh)
        assert got == ((Shard(0), Shard(0), Replicate()) if multi_pod else
                       (Shard(0), Replicate()))
        assert batch == (("pod", "data") if multi_pod else "data")
        with pytest.raises(ValueError, match="ranks"):
            make_fabric_mesh(world + 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_placements_refuse_axes_against_the_mesh_order():
    class Mesh:
        mesh_dim_names = ("data", "model")
    with pytest.raises(ValueError, match="order"):
        tsh.placements_for((("model", "data"),), Mesh())


def test_mesh_module_import_touches_nothing():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import torch.distributed as dist; "
            "import repro_torch.launch.mesh; "
            "import repro_torch.distributed; "
            "print(dist.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=_repo())
    assert out.stdout.strip() == "False"


# --------------------------------------------------------------------------
# the codec, one process
# --------------------------------------------------------------------------
def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((64, 48)).astype(np.float32) * 0.1,
            "b": [rng.standard_normal((300,)).astype(np.float32),
                  (rng.standard_normal((5, 7)) * 1e-3).astype(np.float32)]}


def _leaves(tree):
    return jax.tree.leaves(tree)


def test_codec_bitwise_against_the_reference():
    g = _grads(0)
    err = jax.tree.map(lambda a: np.random.default_rng(1).standard_normal(
        a.shape).astype(np.float32) * 1e-3, g)
    je = jcomp.init_error_feedback(g)
    te = tcomp.init_error_feedback(jax.tree.map(torch.from_numpy, g))
    for a, b in zip(_leaves(je), _leaves(te)):
        assert b.dtype == torch.float32 and np.array_equal(np.asarray(a),
                                                           b.numpy())
    for gl, el in zip(_leaves(g), _leaves(err)):
        jq, js, jn = jcomp.compress_int8(jnp.asarray(gl), jnp.asarray(el))
        tq, ts, tn = tcomp.compress_int8(torch.from_numpy(gl),
                                         torch.from_numpy(el))
        assert tq.dtype == torch.int8 and ts.dim() == 0
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.asarray(js).tobytes() == ts.numpy().tobytes()
        assert np.asarray(jn).tobytes() == tn.numpy().tobytes()
        jd = jcomp.decompress_int8(jq, js)
        assert np.asarray(jd).tobytes() == \
            tcomp.decompress_int8(tq, ts).numpy().tobytes()


def test_error_feedback_unbiased_over_time():
    g = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (256,))))
    err = torch.zeros(256)
    acc = torch.zeros(256)
    for _ in range(30):
        q, s, err = tcomp.compress_int8(g, err)
        acc = acc + tcomp.decompress_int8(q, s)
    rel = float(torch.linalg.norm(acc - 30 * g) / torch.linalg.norm(30 * g))
    assert rel < 1e-2


# --------------------------------------------------------------------------
# four gloo ranks, spawned once
# --------------------------------------------------------------------------
def _repo():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _codec_case(rank):
    g = jax.tree.map(torch.from_numpy, _grads(10 + rank))
    err = jax.tree.map(lambda a: torch.from_numpy(a * np.float32(1e-2)),
                       _grads(20 + rank))
    mean, new_err = tcomp.compressed_psum(g, err)
    qs = [tcomp.compress_int8(a, e)[0] for a, e in
          zip(_leaves(g), _leaves(err))]
    return {"mean": [t.numpy() for t in _leaves(mean)],
            "err": [t.numpy() for t in _leaves(new_err)],
            "q": [t.numpy() for t in qs]}


def _step_case(arch, mesh, opt_name="adamw"):
    """The sharded step against the single-process one, on the same
    gradients for the update."""
    from repro_torch.data import make_pipeline
    from repro_torch.optim import make_optimizer

    cfg = tcfg.get_smoke_config(arch)
    batch = {k: torch.from_numpy(v) for k, v in
             make_pipeline(cfg.vocab_size, B, S, seed=1).peek(0).items()}
    init, update = make_optimizer(opt_name, LR)
    ref = t_build(cfg, device="cpu", seed=0, trainable=True)
    ref_tree = param_tree(ref)
    ref_state = init(ref_tree)
    ref_loss = ref.train_forward(batch)
    ref_loss.backward()
    ref_grads = {k: [p.grad.clone() for p in parts]
                 for k, parts in ref_tree.items()}

    model = t_build(cfg, device="cpu", seed=0, trainable=True)
    state = init(param_tree(model))
    seen = {}

    def capture(grads, st, params, step):
        # copied: full_tensor() of a replicated gradient is its local
        # tensor, which the update's clip then scales in place
        seen.update({k: [g.full_tensor().clone() for g in parts]
                     for k, parts in grads.items()})
        return update(grads, st, params, step)

    rules = _rules("train", False, arch)
    step_fn = tsteps.make_sharded_train_step(model, capture, mesh, rules)
    tree = param_tree(model)
    local = sum(p.to_local().numel() for parts in tree.values()
                for p in parts)
    total = sum(p.numel() for parts in tree.values() for p in parts)
    loss, gnorm = step_fn(state, batch, 0)
    update({k: [g.clone() for g in parts] for k, parts in seen.items()},
           ref_state, ref_tree, 0)
    ratio = lambda got, want: float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)
    worst = {"grad": 0.0, "param": 0.0, "moment": 0.0}
    for key, parts in tree.items():
        for i, p in enumerate(parts):
            worst["grad"] = max(worst["grad"], ratio(seen[key][i],
                                                     ref_grads[key][i]))
            worst["param"] = max(worst["param"], ratio(
                p.detach().full_tensor(), ref_tree[key][i].detach()))
    moments = ([(state[n][k][i], ref_state[n][k][i]) for n in ("m", "v")
                for k, parts in state["m"].items()
                for i in range(len(parts))] if opt_name == "adamw" else
               [(t, ref_state["acc"][k][n]) for k, acc in
                state["acc"].items() for n, t in acc.items()])
    for got, want in moments:
        worst["moment"] = max(worst["moment"], ratio(got.full_tensor(),
                                                     want))
    sharded = sum(any(pl.is_shard() for pl in p.placements)
                  for parts in tree.values() for p in parts)
    return {"loss": float(loss), "ref_loss": float(ref_loss.detach()),
            "grad_norm_is_replicated": gnorm.dim() == 0, "worst": worst,
            "local_share": local / total, "sharded_leaves": sharded,
            "leaves": sum(len(parts) for parts in tree.values())}


def _order_case(mesh):
    """This rank's coordinate and its slice of an 8-row tensor sharded
    over ``("data", "model")`` on dim 0."""
    from torch.distributed.tensor import distribute_tensor
    parts = (("data", "model"),)
    t = distribute_tensor(torch.arange(8.0), mesh,
                          tsh.placements_for(parts, mesh))
    return {"coord": list(mesh.get_coordinate()),
            "rows": [int(x) for x in t.to_local()]}


def _restore_case(mesh, rank, directory):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    gen = torch.Generator().manual_seed(3)
    full = {"w": torch.randn(8, 6, generator=gen),
            "opt": [torch.randn(4, generator=gen).to(torch.bfloat16)]}
    if rank == 0:
        save_checkpoint(directory, 5, full, {"data_step": 5})
    dist.barrier()
    pl_w = (Shard(0), Shard(1))
    like = {"w": torch.zeros(8, 6), "opt": [distribute_tensor(
        torch.zeros(4, dtype=torch.bfloat16), mesh, (Replicate(), Shard(0)))]}
    held = like["opt"][0]
    tree, extras = restore_checkpoint(
        directory, 5, like, shardings={"w": (mesh, pl_w),
                                       "opt.0": (mesh, held.placements)})
    return {"extras": extras,
            "w_equal": torch.equal(tree["w"].full_tensor(), full["w"]),
            "w_placements": tree["w"].placements == pl_w,
            "opt_in_place": tree["opt"][0] is held,
            "opt_equal": torch.equal(held.full_tensor(), full["opt"][0])}


def _rank_main(rank, world, store_path, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(2, device_type="cpu")
        res = {"codec": _codec_case(rank), "order": _order_case(mesh),
               "restore": _restore_case(mesh, rank,
                                        os.path.join(out_dir, "ckpt"))}
        for arch in STEP_ARCHS:
            res[arch] = _step_case(arch, mesh)
        res["adafactor"] = _step_case("qwen2_5_3b", mesh, "adafactor")
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("gloo")
    mp.start_processes(_rank_main, args=(WORLD, str(d / "store"), str(d)),
                       nprocs=WORLD, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_compressed_psum_on_four_ranks_against_the_reference_vmap(ranks):
    grads = [_grads(10 + r) for r in range(WORLD)]
    errs = [jax.tree.map(lambda a: a * np.float32(1e-2), _grads(20 + r))
            for r in range(WORLD)]
    stack = lambda trees: jax.tree.map(lambda *a: jnp.stack(a), *trees)
    mean, new_err = jax.vmap(
        lambda g, e: jcomp.compressed_psum(g, e, "w"), axis_name="w")(
        stack(grads), stack(errs))
    for r, res in enumerate(r["codec"] for r in ranks):
        for i, (g, e) in enumerate(zip(_leaves(grads[r]), _leaves(errs[r]))):
            q, _, _ = jcomp.compress_int8(jnp.asarray(g), jnp.asarray(e))
            assert np.array_equal(res["q"][i], np.asarray(q))
            assert res["err"][i].tobytes() == \
                np.asarray(_leaves(new_err)[i][r]).tobytes()
            want = np.asarray(_leaves(mean)[i][r])
            assert np.abs(res["mean"][i] - want).max() <= MEAN_TOL * \
                np.abs(want).max()
        for i in range(len(res["mean"])):
            assert np.array_equal(res["mean"][i], ranks[0]["codec"]["mean"][i])


def _check_step(ranks, key):
    for res in ranks:
        got = res[key]
        assert abs(got["loss"] - got["ref_loss"]) <= LOSS_TOL * abs(
            got["ref_loss"])
        assert got["worst"]["grad"] <= GRAD_TOL, got["worst"]
        assert got["worst"]["param"] <= STEP_TOL, got["worst"]
        assert got["worst"]["moment"] <= STEP_TOL, got["worst"]
        assert got["grad_norm_is_replicated"]
        # the parameters stay sharded: no rank holds the whole model
        assert got["sharded_leaves"] > got["leaves"] // 2
        assert got["local_share"] < 0.75
    assert len({r[key]["loss"] for r in ranks}) == 1


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_sharded_train_step_on_four_ranks_matches_one_process(ranks, arch):
    _check_step(ranks, arch)


def test_sharded_adafactor_step_on_four_ranks_matches_one_process(ranks):
    """qwen2.5-3b's smoke step with Adafactor: its row / col / v state
    placed by ``opt_state_shardings``, updated on DTensors."""
    _check_step(ranks, "adafactor")


def test_two_axis_part_is_laid_out_as_the_reference(ranks):
    code = (
        "import json, jax, numpy as np\n"
        "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P\n"
        "d = np.array(jax.devices()).reshape(2, 2)\n"
        "ns = NamedSharding(Mesh(d, ('data', 'model')), P(('data', 'model')))\n"
        "m = ns.devices_indices_map((8,))\n"
        "out = {f'{i},{j}': list(range(8))[m[d[i, j]][0]] "
        "for i in range(2) for j in range(2)}\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, env=env)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = {",".join(map(str, r["order"]["coord"])): r["order"]["rows"]
           for r in ranks}
    assert got == want


def test_restore_checkpoint_places_each_leaf(ranks):
    for res in ranks:
        got = res["restore"]
        assert got["extras"] == {"data_step": 5}
        assert got["w_equal"] and got["w_placements"]
        assert got["opt_in_place"] and got["opt_equal"]
