"""Port: the MoE and hybrid families on a DeviceMesh, and the ops DTensor
places there, against the JAX package and the single process.

* **The expert products.** ``models.moe.apply_moe`` runs the experts as
  batched products over contiguous ``[E, B*C, D]`` operands (one form for
  plain tensors and DTensors); the layer and its aux loss against
  ``repro.models.moe.apply_moe`` within 1e-6 of the output's largest
  magnitude (f32), with drops, dropless and with the shared expert; and
  bitwise the layer with the einsum products they replaced (f32, bf16).
* **The scan as one op.** ``torch.ops.repro_torch.selective_scan`` on the
  CPU against the reference's ``selective_scan_ref`` and its final state
  at 2e-5 (``test_torch_mamba.py``'s ``SCAN_TOL``); on ``meta`` tensors
  it is one op of the outputs' shapes, and ``FlopCounterMode`` counts it
  by its formula, ``B S di (7 N + 1)``.
* **Four gloo ranks**, spawned once for the file from a ``FileStore``
  under ``tmp_path``, each writing its results to a file:
  ``make_sharded_train_step`` on a (2, 2) data x model mesh, phi3.5-moe's
  and jamba's smoke configs (f32) under ``RULES_TRAIN``, against the
  single-process step: the loss within 1e-6 relative, every gradient and
  every updated parameter within 1e-5 of its leaf's largest magnitude
  (the update applied to the sharded step's gradients, copied before it
  clips them in place); and ``make_sharded_prefill`` under
  ``RULES_SERVE``, its logits and decode state against the unsharded
  prefill's within 1e-5 of their largest magnitude, jamba's Mamba layers
  each one scan op on the ranks' shards.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.selective_scan import ref as jref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.kernels.selective_scan import ops as so  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import param_tree  # noqa: E402

WORLD = 4
ARCHS = ("phi35_moe_42b", "jamba_v01_52b")
LAYER_TOL, SCAN_TOL = 1e-6, 2e-5
LOSS_TOL, GRAD_TOL, STEP_TOL, PREFILL_TOL = 1e-6, 1e-5, 1e-5, 1e-5
B, S, LR = 4, 16, 1e-4


def _ratio(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


# --------------------------------------------------------------------------
# the expert products and the scan op, in this process
# --------------------------------------------------------------------------
@pytest.mark.parametrize("cf,dropless,n_shared", [(1.0, False, 0),
                                                  (0.5, False, 1),
                                                  (1.25, True, 0),
                                                  (1.25, True, 2)])
def test_expert_products_against_the_reference(cf, dropless, n_shared):
    Bm, Sm, d, F, E, k = 3, 12, 32, 24, 8, 2
    rng = np.random.default_rng(int(cf * 4) + 2 * n_shared + dropless)
    w = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(
        np.float32)
    p = {"wr": w(d, E), "wg": w(E, d, F), "wu": w(E, d, F),
         "wd": w(E, F, d)}
    if n_shared:
        p["shared"] = {"wg": w(d, F * n_shared), "wu": w(d, F * n_shared),
                       "wd": w(F * n_shared, d)}
    x = rng.standard_normal((Bm, Sm, d)).astype(np.float32)
    tree = lambda t, fn: {n: tree(v, fn) if isinstance(v, dict) else fn(v)
                          for n, v in t.items()}
    jy, jaux = jmoe.apply_moe(tree(p, jnp.asarray), jnp.asarray(x), k, cf,
                              dropless=dropless)
    ty, taux = tmoe.apply_moe(tree(p, torch.from_numpy), torch.from_numpy(x),
                              k, cf, dropless=dropless)
    jy = torch.from_numpy(np.array(jy))
    assert _ratio(ty, jy) <= LAYER_TOL
    assert abs(float(taux) - float(jaux)) <= LAYER_TOL * abs(float(jaux))


def _einsum_products(eb, p, f, B, E, C, D):
    """The einsum form the batched expert products replaced."""
    e = eb.reshape(B, E, C, D)
    h = f(torch.einsum("becd,edf->becf", e, p["wg"])) \
        * torch.einsum("becd,edf->becf", e, p["wu"])
    return torch.einsum("becf,efd->becd", h, p["wd"]).reshape(B, E * C, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_products_are_the_einsum_form_bitwise(dtype, monkeypatch):
    """The layer's output with the batched products equals, bit for bit,
    the output with the einsum products they replaced: prefill, decode
    and dropped groups (so routing and emitted tokens stay)."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(5)
    E, D, F = 8, 32, 48
    p = {"wr": torch.randn(D, E, generator=g).to(dt),
         "wg": (torch.randn(E, D, F, generator=g) / 8).to(dt),
         "wu": (torch.randn(E, D, F, generator=g) / 8).to(dt),
         "wd": (torch.randn(E, F, D, generator=g) / 8).to(dt)}
    for B, S, dropless in ((3, 12, True), (4, 1, True), (2, 16, False)):
        x = torch.randn(B, S, D, generator=g).to(dt)
        want, aux = tmoe.apply_moe(p, x, 2, 1.25, dropless=dropless)
        with monkeypatch.context() as m:
            m.setattr(tmoe, "_expert_products", _einsum_products)
            ref, ref_aux = tmoe.apply_moe(p, x, 2, 1.25, dropless=dropless)
        assert torch.equal(want, ref) and torch.equal(aux, ref_aux)


def _scan_inputs(Bs, Ss, di, N, seed):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((Bs, Ss, di)) - 2)).astype(
        np.float32)
    b, c = (rng.standard_normal((Bs, Ss, N)).astype(np.float32)
            for _ in range(2))
    x = rng.standard_normal((Bs, Ss, di)).astype(np.float32)
    a = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    return dt, b, c, x, a


@pytest.mark.parametrize("Bs,Ss,di,N", [(2, 16, 8, 4), (1, 33, 5, 16)])
def test_scan_op_against_the_reference(Bs, Ss, di, N):
    ins = _scan_inputs(Bs, Ss, di, N, seed=Ss)
    y, h = torch.ops.repro_torch.selective_scan(*map(torch.from_numpy, ins))
    jy = np.asarray(jref.selective_scan_ref(*map(jnp.asarray, ins)))
    jh = np.asarray(jref.selective_scan_state_ref(*map(jnp.asarray, ins)))
    np.testing.assert_allclose(y.numpy(), jy, atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), jh, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_scan_is_one_op_on_meta_with_its_flop_formula():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    Bs, Ss, di, N = 2, 4096, 64, 16
    ins = [torch.empty(s, device="meta") for s in
           ((Bs, Ss, di), (Bs, Ss, N), (Bs, Ss, N), (Bs, Ss, di), (di, N))]

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    with Ops() as ops, FlopCounterMode(display=False) as fc:
        y, h = so.selective_scan(*ins, return_state=True)
    assert ops.names == ["repro_torch.selective_scan.default"]
    assert y.shape == (Bs, Ss, di) and h.shape == (Bs, di, N)
    assert y.device.type == h.device.type == "meta"
    assert fc.get_total_flops() == Bs * Ss * di * (7 * N + 1)


# --------------------------------------------------------------------------
# four gloo ranks, spawned once
# --------------------------------------------------------------------------
def _batch(cfg):
    from repro_torch.data import make_pipeline
    return {k: torch.from_numpy(v) for k, v in
            make_pipeline(cfg.vocab_size, B, S, seed=1).peek(0).items()}


def _step_case(arch, mesh):
    """The sharded step against the single-process one, the update on
    the sharded step's gradients."""
    from repro_torch.optim import make_optimizer

    cfg = tcfg.get_smoke_config(arch)
    batch = _batch(cfg)
    init, update = make_optimizer("adamw", LR)
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
        # copied: the update's clip scales the gradients in place
        seen.update({k: [g.full_tensor().clone() for g in parts]
                     for k, parts in grads.items()})
        return update(grads, st, params, step)

    rules = tsh.rules_for("train", False)
    step_fn = tsteps.make_sharded_train_step(model, capture, mesh, rules)
    loss, _ = step_fn(state, batch, 0)
    update({k: [g.clone() for g in parts] for k, parts in seen.items()},
           ref_state, ref_tree, 0)
    tree = param_tree(model)
    worst = {"grad": 0.0, "param": 0.0}
    for key, parts in tree.items():
        for i, p in enumerate(parts):
            worst["grad"] = max(worst["grad"], _ratio(seen[key][i],
                                                      ref_grads[key][i]))
            worst["param"] = max(worst["param"], _ratio(
                p.detach().full_tensor(), ref_tree[key][i].detach()))
    sharded = sum(any(pl.is_shard() for pl in p.placements)
                  for parts in tree.values() for p in parts)
    return {"loss": float(loss), "ref_loss": float(ref_loss.detach()),
            "worst": worst, "sharded_leaves": sharded}


def _prefill_case(arch, mesh):
    """The sharded prefill's logits and state against the unsharded
    prefill's; the scan ops its Mamba layers ran."""
    import repro_torch.kernels.selective_scan.ops as ops

    cfg = tcfg.get_smoke_config(arch)
    tokens = _batch(cfg)["tokens"]
    ref = t_build(cfg, device="cpu", seed=0)
    with torch.no_grad():
        want_logits, want_state = ref.prefill(tokens, S)
    model = t_build(cfg, device="cpu", seed=0)
    rules = tsh.rules_for("serve", False)
    plain = ops._scan
    scans = []

    def counted(*args):
        scans.append(type(args[0]).__name__)
        return plain(*args)

    ops._scan = counted
    try:
        logits, state = tsteps.make_sharded_prefill(model, mesh, rules)(
            {"tokens": tokens}, S)
    finally:
        ops._scan = plain
    worst = _ratio(logits.full_tensor(), want_logits)
    for blk, want in zip(state["blocks"], want_state["blocks"]):
        for k, t in blk.items():
            worst = max(worst, _ratio(t.full_tensor(), want[k]))
    return {"worst": worst, "scans": scans,
            "logits_dtensor": type(logits).__name__ == "DTensor"}


def _rank_main(rank, world, store_path, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(2, device_type="cpu")
        res = {}
        for arch in ARCHS:
            res[arch] = {"step": _step_case(arch, mesh),
                         "prefill": _prefill_case(arch, mesh)}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("gloo_moe")
    mp.start_processes(_rank_main, args=(WORLD, str(d / "store"), str(d)),
                       nprocs=WORLD, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_on_four_ranks_matches_one_process(ranks, arch):
    for res in ranks:
        got = res[arch]["step"]
        assert abs(got["loss"] - got["ref_loss"]) <= LOSS_TOL * abs(
            got["ref_loss"])
        assert got["worst"]["grad"] <= GRAD_TOL, got["worst"]
        assert got["worst"]["param"] <= STEP_TOL, got["worst"]
        assert got["sharded_leaves"] > 0
    assert len({r[arch]["step"]["loss"] for r in ranks}) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_on_four_ranks_matches_one_process(ranks, arch):
    n_mamba = sum(k["mix"] == "mamba" for k in
                  tcfg.get_smoke_config(arch).layer_kinds())
    for res in ranks:
        got = res[arch]["prefill"]
        assert got["logits_dtensor"]
        assert got["worst"] <= PREFILL_TOL, got["worst"]
        # one scan op a Mamba layer, run on this rank's plain shards
        assert got["scans"] == ["Tensor"] * n_mamba


def test_a_stack_shorter_than_its_pattern_is_one_period():
    """jamba's first two layers (the card's ``mesh_train`` case): the
    Mamba + MLP and Mamba + MoE layers, one period of two, where the
    reference's period search (lcm 8, stepped up until it tiles the
    stack) never ends."""
    import dataclasses
    cfg = dataclasses.replace(tcfg.get_config("jamba_v01_52b"), n_layers=2)
    assert cfg.scan_period() == 2
    assert [(k["mix"], k["ff"]) for k in cfg.layer_kinds()] == [
        ("mamba", "mlp"), ("mamba", "moe")]
    for arch in tcfg.ARCHS:
        full = tcfg.get_config(arch)
        assert full.n_layers % full.scan_period() == 0
