"""Port: the dry run's cells (item 4d) against the JAX package.

* **Input specs.** All 40 arch x shape cells, smoke and full configs:
  ``configs.input_specs`` gives the reference's skip strings (33 cells
  run, 7 skip: ``long_500k`` on the pure full-attention archs) and, as
  ``meta`` tensors, the reference's shapes and dtypes of every batch leaf
  and of the decode token; the decode state is the port's model's own,
  each leaf the reference's stacked leaf without its leading period axis
  (the encoder-decoder's, stacked over layers as there, equal).
* **Decode state specs.** ``decode_state_specs()`` of every config equals
  the reference's ``decode_state_specs`` per leaf (without the leading
  ``"layers"`` of a period-stacked leaf).
* **Placements.** ``build_cell``'s PartitionSpec parts of every input
  (parameters, optimizer state, batch, decode token and state) on the
  fake 256- and 512-chip meshes equal the reference's ``build_cell``'s
  ``in_shardings``, captured as ``tests/test_torch_distributed.py``
  captures them (``NamedSharding`` patched to its spec's parts, and
  ``jax.jit`` to its keyword arguments), for every config and every
  shape the config runs.
* **The cost pass.** ``dryrun.run_cell`` on qwen2.5-3b's smoke config,
  one cell of each kind, on the 256-rank production mesh of torch's fake
  process group: the reference's record keys, ``null`` and
  ``not_ported`` for what only XLA gives, argument bytes equal to the
  local shards' sizes from the parts (each mesh dim splits a dim as
  ``torch.chunk`` does, rank 0's share), collectives of every kind the
  mesh shards with (nonzero count and bytes, and ``CommDebugMode``'s
  counts equal the tally's), and the step's FLOPs against the analytic
  count: decode and prefill within 1e-9 relative (every product of the
  step at global shapes), train within 5% (see
  ``test_run_cell_records_one_cell_of_each_kind``).
"""

import json
import math
import pathlib
import re

import jax
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jcfg  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.convert import _ref_get  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import param_tree  # noqa: E402
from repro_torch.optim.common import stacked, tree_key  # noqa: E402


class FakeMesh:
    shape = {"data": 16, "model": 16, "pod": 2}


class OnePod:
    shape = {"data": 16, "model": 16}


def _dtype(jdt) -> torch.dtype:
    return getattr(torch, jax.numpy.dtype(jdt).name)


def _check_leaf(got, want, where):
    assert got.device.type == "meta", where
    assert tuple(got.shape) == tuple(want.shape), where
    assert got.dtype == _dtype(want.dtype), where


def _state_pairs(cfg, got: dict, want: dict):
    """(port leaf, reference leaf or its per-period row, path) pairs of a
    decode state (``pos`` apart)."""
    if cfg.family == "encdec":
        for part in ("self_kv", "cross_kv"):
            for k in ("k", "v"):
                yield got[part][k], want[part][k], (part, k), False
        return
    P = cfg.scan_period()
    assert len(want["blocks"]) == P and len(got["blocks"]) == cfg.n_layers
    for layer, blk in enumerate(got["blocks"]):
        ref = want["blocks"][layer % P]
        assert set(blk) == set(ref), layer
        for k in blk:
            yield blk[k], ref[k], (layer, k), True


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", tcfg.ARCHS)
def test_input_specs_match_the_reference(arch, smoke):
    for shape in tcfg.SHAPES:
        want = jcfg.input_specs(arch, shape, smoke=smoke)
        got = tcfg.input_specs(arch, shape, smoke=smoke)
        assert got["skip"] == want["skip"], shape
        assert got["shape"].__dict__ == want["shape"].__dict__
        assert got["cfg"].__dict__ == want["cfg"].__dict__
        if want["skip"]:
            assert "batch" not in got
            continue
        gb, wb = got["batch"], want["batch"]
        assert set(gb) == set(wb), shape
        if got["shape"].kind != "decode":
            for k in wb:
                _check_leaf(gb[k], wb[k], (shape, k))
            continue
        _check_leaf(gb["token"], wb["token"], (shape, "token"))
        assert gb["state"]["pos"] == 0 and wb["state"]["pos"].shape == ()
        for g, w, path, per_layer in _state_pairs(got["cfg"], gb["state"],
                                                wb["state"]):
            assert tuple(g.shape) == tuple(w.shape[1:] if per_layer
                                           else w.shape), (shape, path)
            assert g.dtype == _dtype(w.dtype) and g.device.type == "meta"


def test_forty_cells_thirty_three_run_seven_skip():
    skips = {(a, s): tcfg.input_specs(a, s)["skip"] for a in tcfg.ARCHS
             for s in tcfg.SHAPES}
    assert len(skips) == 40
    assert sum(v is None for v in skips.values()) == 33
    skipped = sorted(k for k, v in skips.items() if v)
    assert len(skipped) == 7 and {s for _, s in skipped} == {"long_500k"}
    for (a, s), reason in skips.items():
        assert reason == jcfg.skip_reason(jcfg.get_config(a), s)
        assert tcfg.supports_long_context(tcfg.get_config(a)) == \
            jcfg.supports_long_context(jcfg.get_config(a))


@pytest.mark.parametrize("arch", tcfg.ARCHS)
def test_decode_state_specs_match_the_reference(arch):
    from repro.models.model import build_model as j_build
    cfg = tcfg.get_config(arch)
    want = j_build(jcfg.get_config(arch)).decode_state_specs()
    got = build_model(cfg, device="meta", seed=None).decode_state_specs()
    assert got["pos"] == want["pos"] == ()
    for g, w, path, per_layer in _state_pairs(cfg, got, want):
        assert w[0] == "layers", path
        assert g == (w[1:] if per_layer else w), path


# --------------------------------------------------------------------------
# placements against the reference's build_cell
# --------------------------------------------------------------------------
def _ref_cell(monkeypatch, arch, shape, mesh, multi_pod):
    """The reference's build_cell with its ``in_shardings`` captured as
    PartitionSpec parts."""
    from repro.distributed import activations as jacts
    for mod in (jsh, jsteps, jacts):
        monkeypatch.setattr(mod, "NamedSharding",
                            lambda m, spec: tuple(spec))
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: kw)
    try:
        return jsteps.build_cell(arch, shape, mesh, multi_pod=multi_pod)
    finally:
        for hook in ("set_attn_sharding", "set_matmul_input_sharding",
                     "set_decode_logits_sharding"):
            getattr(jacts, hook)(None)
        jacts.set_activation_sharding(None, None)


def _param_parts_match(model, got: dict, want_tree):
    P = model.cfg.scan_period()
    names = {}
    for name in got:
        names.setdefault(tree_key(name, P)[0], []).append(name)
    n = 0
    for key, parts in param_tree(model).items():
        want = _ref_get(want_tree, key)
        for name in names[key]:
            assert got[name] == (want[1:] if stacked(key) else want), key
            n += 1
    assert n == len(got)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", tcfg.ARCHS)
def test_build_cell_placements_match_the_reference(arch, multi_pod,
                                                   monkeypatch):
    mesh = FakeMesh() if multi_pod else OnePod()
    for shape in tcfg.SHAPES:
        cell = tsteps.build_cell(arch, shape, mesh, multi_pod=multi_pod)
        ref = _ref_cell(monkeypatch, arch, shape, mesh, multi_pod)
        monkeypatch.undo()
        assert (cell.kind, cell.skip) == (ref.kind, ref.skip), shape
        if cell.skip:
            assert cell.step_fn is None and cell.shardings is None
            continue
        ins = ref.step_fn["in_shardings"]
        sh = cell.shardings
        _param_parts_match(cell.model, sh["params"], ins[0])
        if cell.kind == "train":
            pspecs, _ = tsteps.tree_specs(cell.model)
            for key in pspecs:
                for part, want in (("m", ins[1].get("m")),
                                   ("v", ins[1].get("v")),
                                   ("acc", ins[1].get("acc"))):
                    if want is not None:
                        assert sh["opt_state"][part][key] == \
                            _ref_get(want, key), (shape, part, key)
            assert sh["batch"] == ins[2] and ins[3] == ()
        elif cell.kind == "prefill":
            assert sh["batch"] == ins[1]
        else:
            assert sh["token"] == ins[1], shape
            assert sh["state"]["pos"] == ins[2]["pos"] == ()
            for g, w, path, per_layer in _state_pairs(cell.cfg, sh["state"],
                                                    ins[2]):
                assert g == (w[1:] if per_layer else w), (shape, path)
                if per_layer:
                    assert w[0] is None


# --------------------------------------------------------------------------
# run_cell on the fake process group
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fake_group():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import start_fake_group
    start_fake_group(multi_pod=False)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_numel(shape, parts, sizes: dict) -> int:
    """Rank 0's share of a tensor of ``shape`` under ``parts``: each mesh
    axis of a dim's part splits it in turn, as ``torch.chunk`` does."""
    n = 1
    for i, d in enumerate(shape):
        part = parts[i] if i < len(parts) else None
        for ax in ((part,) if isinstance(part, str) else part or ()):
            d = -(-d // sizes[ax])
        n *= d
    return n


def _expected_bytes(tree, parts, sizes) -> int:
    if isinstance(tree, torch.Tensor):
        return _local_numel(tree.shape, parts, sizes) * tree.element_size()
    if isinstance(tree, dict):
        return sum(_expected_bytes(tree[k], parts[k], sizes) for k in tree
                   if k != "pos")
    return sum(_expected_bytes(t, p, sizes) for t, p in zip(tree, parts))


def _analytic(cfg, kind: str, B: int, S: int) -> float:
    """FLOPs of qwen2.5-3b's smoke step by its products: projections and
    MLP ``2 N`` a weight element (N tokens), the lm head, attention ``4 S
    dh`` a query a head over every key (the port's decode reads the whole
    cache, its prefill attention is the plain version's full product,
    its train attention visits every key block)."""
    d, L, Hq, Hkv, dh, V, F = (cfg.d_model, cfg.n_layers, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim,
                               cfg.padded_vocab, cfg.d_ff)
    w = L * (2 * d * Hq * dh + 2 * d * Hkv * dh + 3 * d * F)
    if kind == "decode":
        return 2 * B * (w + d * V) + 4 * B * Hq * S * dh * L
    if kind == "prefill":
        return 2 * B * S * w + 2 * B * d * V + 4 * B * Hq * S * S * dh * L
    # train, remat on: each product four times (forward, the block's
    # recompute, the two gradient products), the loss's chunks as well;
    # attention runs on each rank's batch shard (1/16 of the rows on the
    # data axis) five times (forward, the block's recompute, its chunk's
    # recompute, two gradient products)
    return 4 * 2 * B * S * (w + d * V) + 5 * 4 * B * Hq * S * S * dh * L / 16


def test_run_cell_records_one_cell_of_each_kind(fake_group):
    """The train cell's count sits 2.2% under its analytic count: the
    step runs 6 ``[N, 128] x [128, 64]`` products where the count has 8
    (the MLP's down projection twice and the input gradients of its two
    up projections); the test holds 5%."""
    from repro_torch.launch import dryrun
    cfg = tcfg.get_smoke_config("qwen2_5_3b")
    sizes = {"data": 16, "model": 16}
    tol = {"decode": 1e-9, "prefill": 1e-9, "train": 0.05}
    for shape in ("decode_32k", "prefill_32k", "train_4k"):
        rec = dryrun.run_cell("qwen2_5_3b", shape, False, smoke=True)
        json.dumps(rec)                              # a JSON record
        sp = tcfg.SHAPES[shape]
        assert rec["kind"] == sp.kind and rec["n_chips"] == 256
        assert rec["mesh"] == sizes and rec["multi_pod"] is False
        for key in dryrun.NOT_PORTED:
            head, _, leaf = key.partition(".")
            assert (rec[head][leaf] if leaf else rec[key]) is None, key
        assert rec["not_ported"] == dryrun.NOT_PORTED
        # argument bytes: the parameters', the optimizer state's and the
        # batch's (or token's and state's) local shards
        cell = tsteps.build_cell("qwen2_5_3b", shape, OnePod(), smoke=True)
        model = cell.model
        want = sum(_local_numel(p.shape, cell.shardings["params"][n], sizes)
                   * p.element_size() for n, p in model.named_parameters())
        if sp.kind == "train":
            opt, batch, _ = cell.args
            want += _expected_bytes(batch, cell.shardings["batch"], sizes)
            pspecs, _ = tsteps.tree_specs(model)
            for part in ("m", "v"):
                for key, leaves in opt[part].items():
                    parts = cell.shardings["opt_state"][part][key]
                    parts = parts[1:] if stacked(key) else parts
                    want += sum(_local_numel(t.shape, parts, sizes)
                                * t.element_size() for t in leaves)
        elif sp.kind == "prefill":
            want += _expected_bytes(cell.args[0], cell.shardings["batch"],
                                    sizes)
        else:
            token, state = cell.args
            want += _local_numel(token.shape, cell.shardings["token"],
                                 sizes) * token.element_size()
            want += _expected_bytes(state, cell.shardings["state"], sizes)
        assert rec["memory"]["argument_bytes"] == want, shape
        assert rec["memory"]["output_bytes"] > 0
        coll = rec["collectives"]
        assert coll == rec["collectives_loop_aware"]
        assert {k: v["count"] for k, v in coll.items()} == \
            rec["collectives_comm_debug"]
        assert sum(v["count"] for v in coll.values()) > 0, shape
        assert all(v["bytes"] > 0 for v in coll.values()), shape
        assert 0 < rec["cost"]["flops"] and rec["hbm_write_bytes"] > 0
        want_flops = _analytic(cfg, sp.kind, sp.global_batch, sp.seq_len)
        assert math.isclose(rec["flops_global"], want_flops,
                            rel_tol=tol[sp.kind]), (shape, rec["flops_global"],
                                                    want_flops)


def test_run_cell_skips_with_the_reference_reason(fake_group):
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell("qwen2_5_3b", "long_500k", False)
    assert rec["skip"] == jcfg.skip_reason(jcfg.get_config("qwen2_5_3b"),
                                           "long_500k")
    assert "memory" not in rec
    with pytest.raises(ValueError, match="512"):
        dryrun.run_cell("qwen2_5_3b", "decode_32k", True, smoke=True)


def test_dryrun_cli_flags_are_the_reference_s():
    """The CLI's flags, read from both sources (importing the reference's
    module would set ``XLA_FLAGS`` for the process)."""
    root = pathlib.Path(__file__).resolve().parents[1] / "src"
    flags = lambda rel: re.findall(r'add_argument\("(--[\w-]+)"',
                                   (root / rel).read_text())
    assert flags("repro_torch/launch/dryrun.py") == \
        flags("repro/launch/dryrun.py") == [
            "--arch", "--shape", "--all", "--multi-pod", "--out", "--force"]


# --------------------------------------------------------------------------
# the MoE and recurrent cells (the expert products as batched products,
# the Mamba scan as one op, the recurrences on each rank's shards and
# their counts loop-aware)
# --------------------------------------------------------------------------
MOE_AND_RECURRENT_CELLS = [
    ("phi35_moe_42b", "prefill_32k"), ("phi35_moe_42b", "train_4k"),
    ("llama4_maverick_400b", "prefill_32k"),
    ("llama4_maverick_400b", "train_4k"), ("jamba_v01_52b", "prefill_32k"),
    ("jamba_v01_52b", "train_4k"), ("xlstm_350m", "prefill_32k"),
    ("xlstm_350m", "train_4k")]

#: each recurrent cell's loops and their trip counts (a prefill's loop is
#: the whole sequence; a train route's 32 chunks of 128 steps); the Mamba
#: prefill has none: its scan is one op
LOOPS = {("jamba_v01_52b", "train_4k"): {"mamba.chunks": 32, "mamba": 128},
         ("xlstm_350m", "prefill_32k"): {"mlstm": 32768, "slstm": 32768},
         ("xlstm_350m", "train_4k"): {"mlstm.chunks": 32, "mlstm": 128,
                                      "slstm.chunks": 32, "slstm": 128}}


def _argument_bytes(cell, sizes) -> int:
    """The expected argument bytes of a cell: its parameters', optimizer
    state's (AdamW's per-layer moments, Adafactor's stacked
    accumulators) and batch's local shards, or its token's and state's."""
    model, sh = cell.model, cell.shardings
    want = sum(_local_numel(p.shape, sh["params"][n], sizes)
               * p.element_size() for n, p in model.named_parameters())
    if cell.kind == "train":
        opt, batch, _ = cell.args
        want += _expected_bytes(batch, sh["batch"], sizes)
        for part in ("m", "v"):
            for key, leaves in opt.get(part, {}).items():
                parts = sh["opt_state"][part][key]
                parts = parts[1:] if stacked(key) else parts
                want += sum(_local_numel(t.shape, parts, sizes)
                            * t.element_size() for t in leaves)
        for key, acc in opt.get("acc", {}).items():
            want += sum(_local_numel(t.shape, sh["opt_state"]["acc"][key][n],
                                     sizes) * t.element_size()
                        for n, t in acc.items())
    elif cell.kind == "prefill":
        want += _expected_bytes(cell.args[0], sh["batch"], sizes)
    else:
        token, state = cell.args
        want += _local_numel(token.shape, sh["token"],
                             sizes) * token.element_size()
        want += _expected_bytes(state, sh["state"], sizes)
    return want


@pytest.mark.parametrize("arch,shape", MOE_AND_RECURRENT_CELLS)
def test_moe_and_recurrent_cells_finish(fake_group, arch, shape):
    """The eight cells the expert products' views and the per-step
    recurrences held back, at the smoke widths and the shape's own
    sequence: each finishes with its argument bytes exact, collectives,
    FLOPs, and the trip count of each recurrence it scales."""
    from repro_torch.launch import dryrun
    sizes = {"data": 16, "model": 16}
    rec = dryrun.run_cell(arch, shape, False, smoke=True)
    json.dumps(rec)
    cell = tsteps.build_cell(arch, shape, OnePod(), smoke=True)
    assert rec["memory"]["argument_bytes"] == _argument_bytes(cell, sizes)
    assert rec["memory"]["output_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["flops_global"] > 0
    assert sum(v["count"] for v in rec["collectives"].values()) > 0
    assert {k: v["count"] for k, v in rec["collectives"].items()} == \
        rec["collectives_comm_debug"]
    assert "loop_counts" not in rec["not_ported"]
    want = LOOPS.get((arch, shape), {})
    assert {k: v["trip_count"] for k, v in rec["loop_counts"].items()} == \
        want
    assert all(v["executions"] > 0 for v in rec["loop_counts"].values())


@pytest.mark.parametrize("arch,shape", sorted(LOOPS))
def test_loop_aware_counts_equal_the_full_run(fake_group, monkeypatch, arch,
                                              shape):
    """At a 16-step sequence (the train routes in 4 chunks of 4 steps,
    so that a loop runs within a loop), the counts scaled from one step
    and two (``analyze_step(fresh=)``) equal those of the run of every
    step: this rank's and the step's FLOPs, and the collectives by type,
    count and bytes."""
    from repro_torch.launch import dryrun
    from repro_torch.models import mamba, xlstm
    sp = tcfg.SHAPES[shape]
    monkeypatch.setitem(tcfg.SHAPES, shape,
                        tcfg.ShapeSpec(sp.name, 16, sp.global_batch, sp.kind))
    pick = mamba._pick_chunk
    for mod in (mamba, xlstm):
        monkeypatch.setattr(mod, "_pick_chunk", lambda S: pick(S, 4))
    aware = dryrun.run_cell(arch, shape, False, smoke=True)
    full = dryrun.run_cell(arch, shape, False, smoke=True, loop_aware=False)
    assert set(aware["loop_counts"]) == set(LOOPS[(arch, shape)])
    want = 4 if shape == "train_4k" else 16
    assert all(v["trip_count"] == want
               for v in aware["loop_counts"].values())
    assert full["loop_counts"] == {}
    assert aware["cost"]["flops"] == full["cost"]["flops"] > 0
    assert aware["flops_global"] == full["flops_global"]
    assert aware["collectives"] == full["collectives"]
    assert aware["collectives_comm_debug"] == full["collectives_comm_debug"]
    assert aware["memory"] == full["memory"]
