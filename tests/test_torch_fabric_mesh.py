"""Port: the sharded cold pool's mesh data plane on ``torch.distributed``.

Four gloo ranks, spawned once for the file from a ``FileStore`` under
``tmp_path``, each holding one home slice of the cold pool
(``make_fabric_mesh(4)``), run every case on the mesh plane and write
their results. The tests hold each, on every rank, against the
reference's answer on the same inputs (its flat plane, which it pins
bitwise to its ``shard_map`` plane; its plain versions, attention
included, since a decode attention's mode moves none of the integers)
and bitwise against the port's flat plane in this process:

* the consume scan: the checksums, every ``info`` column and the state
  (the hot payload included), for ``block`` and ``interleave`` at link
  budgets ``None`` and 1, under a chaos spec with node loss (``est_q``
  included) and with the §12 lifecycle's compressed tier;
* the tiered sweep, sync and async (the lifecycle's tables too): every
  ``info`` column and the state; then ``tiered_attention`` bitwise
  against ``paged_decode_attention`` over the flat pool, and within 2e-5
  of the reference's (float sums in another order);
* each rank reads only its own slice: every page not homed on a rank is
  NaN in that rank's copy of the pool, and the results stay bitwise;
* every rank's integers are the same;
* ``ServingEngine`` at ``shards=4``, two-tier and with the §12
  lifecycle, and the batch driver's tiered replay: the report's
  integers, the events and the emitted tokens (the replay's event log)
  of the reference and of the flat run;
* the CLI as ``torchrun`` starts it (``WORLD_SIZE`` / ``RANK`` /
  ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``), ``--shards 4`` on
  the lock-step path with the qwen2.5-3b smoke model: a ``--shards``
  other than the world is refused before any group starts; the launched
  serve rides the ring and gives the report and the event log of the
  port's flat run (its tiered replay is the batch driver's, above);
  rank 0 alone prints and writes the trace; the group is torn down.

The ranks import nothing of the reference: this module imports JAX only
inside its functions, in this process, which computes the reference's and
the flat plane's answers while the ranks run.
"""

import contextlib
import functools
import io
import os
import socket
import tempfile
import types
from dataclasses import astuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tcfg  # noqa: E402
from repro_torch.fabric.chaos import ChaosSpec  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.paging import prefetch_serving as tps  # noqa: E402
from repro_torch.paging import sharded_pool as tsp  # noqa: E402
from repro_torch.paging import tiered_kv as tt  # noqa: E402
from repro_torch.paging.kv_cache import paged_decode_attention  # noqa: E402
from repro_torch.paging.lifecycle import MigrationCfg  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving import batch_driver as tbd  # noqa: E402

WORLD = 4
S, N_PAGES, N_SLOTS, T = 4, 48, 12, 28
CONSUME = {f"{pl}-budget{b}": dict(placement=pl, link_budget=b)
           for pl in ("block", "interleave") for b in (None, 1)}
CONSUME["chaos"] = dict(placement="interleave", link_budget=2,
                        chaos=dict(slowdown=((0, 3, 4, 18), (1, 2, 8, 26)),
                                   degradation=((3, 1, 6, 16),),
                                   node_loss=(3, 11),
                                   grants=((0, 3, 4, 22), (2, 2, 10, 20)),
                                   adaptive_deadline=True))
CONSUME["lifecycle"] = dict(placement="block", link_budget=2,
                            migration=dict(mig_per_stream=2, lead=1,
                                           cooldown=8, compressed=True,
                                           far_capacity=N_PAGES // 2,
                                           demote_per_step=2,
                                           decompress_delay=2))
CONSUME_GEOM = dict(n_pages=N_PAGES, n_slots=N_SLOTS, page_elems=6, pw_max=4,
                    ring_size=4)
B, NPPS, PS, HKV, HQ, DH = 4, 8, 4, 2, 4, 8
SWEEPS = {"sync": dict(async_dp=False, placement="block", budget=None),
          "async": dict(async_dp=True, placement="interleave", budget=1),
          "async-lifecycle": dict(async_dp=True, placement="block",
                                  budget=1, lifecycle=True)}
SWEEP_KW = dict(chunk=2, pw_max=4, ring_size=8)
ENGINE = dict(requests=5, slots=3, prompt_len=8, gen=4, page_size=4,
              prefill_chunk=4, arrival="bursty", burst_len=2, seed=3,
              trace=True, async_datapath=True, attn_kernel="fused_async",
              link_budget=1, shards=4, placement="interleave", far_delay=3)
#: the engine's runs: two-tier, and with the §12 lifecycle (migration and
#: the compressed tier, whose demotions round-trip the cold bytes on every
#: rank)
ENGINES = {"two_tier": ENGINE,
           "lifecycle": dict(ENGINE, migration=dict(
               compressed=True, far_capacity=8, demote_per_step=2,
               decompress_delay=2, cooldown=8))}
#: the batch driver's replay: jamba's smoke K/V heads, 4 x 5 pages over
#: four shards (its chaos sidecar runs on the flat plane in both packages,
#: and is held in ``tests/test_torch_sharded_serve.py``)
DRIVER_ARCH, DRIVER_NB, DRIVER_P, DRIVER_G = "jamba_v01_52b", 4, 16, 4
DRIVER_TIMING = {"span_sweep_ms", "span_attention_ms", "tiered_decode_s",
                 "trace_path"}
BATCH = ["--arch", "qwen2_5_3b", "--smoke", "--device", "cpu", "--batch",
         "4", "--prompt-len", "12", "--gen", "4", "--page-size", "4",
         "--chunk", "2", "--ring-size", "4", "--paged", "--async-datapath",
         "--attn-kernel", "fused-async", "--shards", "4", "--placement",
         "block", "--far-delay", "3", "--link-budget", "2"]
BATCH_TIMING = {"prefill_s", "ttft_s", "decode_tok_per_s", "token_latency",
                "step_time_monitor", "span_sweep_ms", "span_attention_ms",
                "tiered_decode_s", "trace_path"}
ENGINE_TIMING = {"wall_s", "token_latency"}


def _homed_elsewhere(n_pages, fabric, rank):
    """The pages not homed on ``rank`` (as a bool mask)."""
    home = tsp.page_home(torch.arange(n_pages), n_pages, fabric.n_shards,
                         fabric.placement)
    return home != rank


def consume_inputs():
    """``(cold, sched)`` of every consume case, as numpy."""
    rng = np.random.default_rng(7)
    cold = {k: rng.integers(-99, 99, (N_PAGES, 2, 3)).astype(np.float32)
            for k in ("k", "v")}
    t = np.arange(T)
    sched = np.stack([(t * (s + 1) + 5 * s) % N_PAGES
                      for s in range(S)]).astype(np.int32)
    return cold, sched


def consume_fabric(name):
    c = CONSUME[name]
    return dict(n_shards=4, placement=c["placement"],
                link_budget=c["link_budget"], near_delay=1, far_delay=2)


def consume_case(name, mesh=None, poison_rank=None):
    """One consume case of :data:`CONSUME`; with ``poison_rank``, every
    page not homed on that rank is NaN in the pool handed in."""
    c = CONSUME[name]
    cold, sched = consume_inputs()
    cold = {k: torch.from_numpy(v) for k, v in cold.items()}
    fab = tsp.ShardedPoolCfg(**consume_fabric(name))
    if poison_rank is not None:
        away = _homed_elsewhere(N_PAGES, fab, poison_rank)
        for v in cold.values():
            v[away] = float("nan")
    chaos = ChaosSpec(**c["chaos"]) if "chaos" in c else None
    mig = MigrationCfg(**c["migration"]) if "migration" in c else None
    return tsp.sharded_multi_stream_consume(
        cold, torch.from_numpy(sched), tps.PrefetchedStream(**CONSUME_GEOM),
        fab, mesh=mesh, chaos=chaos, migration=mig)


def sweep_inputs():
    """``(cold, rows, q, lengths)`` of every sweep case, as numpy."""
    rng = np.random.default_rng(11)
    n_pages = B * NPPS
    cold = {k: rng.standard_normal((n_pages, PS, HKV, DH)).astype(np.float32)
            for k in ("k", "v")}
    base = np.arange(B)[:, None] * NPPS
    rows = (base + (np.arange(NPPS)[None] * 3) % NPPS).astype(np.int32)
    rows[1, 5:] = -1
    q = rng.standard_normal((B, 1, HQ, DH)).astype(np.float32)
    lengths = np.array([29, 17, 32, 5], np.int32)
    return cold, rows, q, lengths


def sweep_fabric(name):
    c = SWEEPS[name]
    return dict(n_shards=4, placement=c["placement"], link_budget=c["budget"],
                near_delay=1, far_delay=3)


def sweep_lifecycle(name):
    """The §12 tables of a lifecycle sweep, as numpy (none otherwise)."""
    if not SWEEPS[name].get("lifecycle"):
        return {}
    n_pages = B * NPPS
    home = tsp.page_home(torch.arange(n_pages), n_pages, 4, "block").numpy()
    return dict(home_map=np.roll(home, 3).astype(np.int32),
                comp_map=np.arange(n_pages) % 5 == 0, decompress_delay=2)


def sweep_case(name, mesh=None, poison_rank=None):
    """Two tiered sweeps of :data:`SWEEPS` (an invalidation between), then
    a decode step's attention; returns ``(state, [info, info, info], out,
    resident, flat)``."""
    c = SWEEPS[name]
    cold, rows, q, lengths = (
        {k: torch.from_numpy(v) for k, v in a.items()} if isinstance(a, dict)
        else torch.from_numpy(a) for a in sweep_inputs())
    n_pages = B * NPPS
    n_slots = tt.tiered_min_slots(NPPS, tt.TieredKV(n_pages, 1, PS, HKV, DH,
                                                    **SWEEP_KW))
    geom = tt.TieredKV(n_pages, n_slots, PS, HKV, DH, **SWEEP_KW)
    fab = tsp.ShardedPoolCfg(**sweep_fabric(name))
    flat = paged_decode_attention(q, {k: v[None] for k, v in cold.items()},
                                  0, rows, lengths)
    if poison_rank is not None:
        away = _homed_elsewhere(n_pages, fab, poison_rank)
        for v in cold.values():
            v[away] = float("nan")
    life = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in sweep_lifecycle(name).items()}
    st = tt.tiered_init(geom, B, torch.float32, device="cpu")
    infos = []
    for _ in range(2):
        st, info = tt.tiered_sweep(st, cold, rows, geom,
                                   async_datapath=c["async_dp"], fabric=fab,
                                   mesh=mesh, **life)
        infos.append(info)
        st = tt.tiered_invalidate(st, rows[:, 2:3].contiguous())
    st, out, info, ok = tt.tiered_decode_step(
        st, cold, q, rows, lengths, geom, async_datapath=c["async_dp"],
        fabric=fab, mesh=mesh, attn_kernel="fused_async", **life)
    infos.append(info)
    return st, infos, out, bool(ok), flat


class RecordingExecutor:
    """K/V from a numpy generator keyed by (seed, request, position), as
    the reference's engine tests draw them; keeps every token emitted."""

    def __init__(self, n_kv_heads=2, head_dim=8, n_q_heads=4, seed=0):
        self.n_kv_heads, self.head_dim = n_kv_heads, head_dim
        self.n_q_heads, self.dtype, self.seed = n_q_heads, "float32", seed
        self.tokens = []

    def begin(self, req):
        pass

    def end(self, req):
        pass

    def _kv(self, req, start, n):
        kv = np.stack([np.random.default_rng([self.seed, req.req_id, p])
                       .standard_normal((2, self.n_kv_heads, self.head_dim))
                       for p in range(start, start + n)]).astype(np.float32)
        return kv[:, 0], kv[:, 1]

    def prefill_chunk(self, req, n):
        k, v = self._kv(req, req.prefilled, n)
        done = req.prefilled + n >= req.prompt_len
        tok = req.req_id % 251 if done else None
        self.tokens.append((req.req_id, tok))
        return k, v, tok

    def decode(self, req):
        k, v = self._kv(req, req.prefilled + req.decoded - 1, 1)
        tok = (req.req_id + req.decoded) % 251
        self.tokens.append((req.req_id, tok))
        return k[0], v[0], tok


def _engine_result(eng, rep, ex):
    return {"report": rep, "events": [astuple(e) for e in eng.events],
            "tokens": ex.tokens, "shard_hist": np.concatenate(eng.shard_hist),
            "mesh": getattr(eng, "mesh", None) is not None}


def engine_case(name, mesh=None):
    kw = dict(ENGINES[name])
    if "migration" in kw:
        kw["migration"] = MigrationCfg(**kw["migration"])
    ex = RecordingExecutor()
    eng = ServingEngine(ServeConfig(**kw), ex, device="cpu", mesh=mesh)
    return _engine_result(eng, eng.run(), ex)


DRIVER_ARGS = types.SimpleNamespace(
    page_size=4, streams=1, chunk=2, ring_size=4, shards=4,
    placement="interleave", link_budget=2, far_delay=2, attn_kernel="fused",
    gen=4, async_datapath=True, chaos=None)


def driver_kv():
    """The replay's dense K/V ``[nb, P + G, hkv, dh]``, as numpy."""
    cfg = tcfg.get_smoke_config(DRIVER_ARCH)
    rng = np.random.default_rng(0)
    return [rng.standard_normal((DRIVER_NB, DRIVER_P + DRIVER_G,
                                 cfg.n_kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2)]


def _traced(fn):
    """``fn(trace_path)``'s result and the event log it wrote."""
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "t.json")
        res = fn(trace)
        with open(trace + ".jsonl") as f:
            return {"result": res, "events": f.read()}


def driver_case(mesh=None):
    """The batch driver's tiered replay over :func:`driver_kv`; returns its
    report and its event log."""
    k, v = driver_kv()
    state = {"blocks": [{"k": torch.from_numpy(k), "v": torch.from_numpy(v)}]}
    return _traced(lambda trace: tbd.serve_batch_tiered(
        tcfg.get_smoke_config(DRIVER_ARCH), state, DRIVER_ARGS, DRIVER_NB,
        DRIVER_P, DRIVER_P + DRIVER_G, trace_path=trace, mesh=mesh))


# --------------------------------------------------------------------------
# four gloo ranks, spawned once
# --------------------------------------------------------------------------
def _launched_cli(rank, world, port, out_dir):
    """The CLI as ``torchrun`` starts rank ``rank`` of ``world``: a wrong
    ``--shards`` first, then the serve of :data:`BATCH`; what it printed,
    its report, its ring hops, its trace's event log (if it wrote one) and
    whether its group is down."""
    import torch.distributed as dist
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    out = {}
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            tserve.main(BATCH + ["--shards", "2"])
    except SystemExit as e:
        out["refused"] = (e.code, dist.is_initialized())
    trace = os.path.join(out_dir, f"cli{rank}.json")
    tsp.reset_ring_stats()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = tserve.main(BATCH + ["--trace", trace])
    out.update(printed=buf.getvalue(), report=rep,
               hops=tsp.ring_stats()["hops"],
               trace=(open(trace + ".jsonl").read()
                      if os.path.exists(trace + ".jsonl") else None),
               torn_down=not dist.is_initialized())
    return out


def _rank_main(rank, world, store_path, out_dir, port):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_fabric_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_fabric_mesh(world)
        group, shard = tsp.fabric_plane(mesh)
        res = {"plane": (shard, dist.get_backend(group))}
        tsp.reset_ring_stats()
        res["consume"] = {n: consume_case(n, mesh) for n in CONSUME}
        res["consume_poisoned"] = consume_case("chaos", mesh, rank)
        res["sweep"] = {n: sweep_case(n, mesh) for n in SWEEPS}
        res["sweep_poisoned"] = sweep_case("async", mesh, rank)
        res["ring"] = tsp.ring_stats()
        res["engine"] = {n: engine_case(n, mesh) for n in ENGINES}
        res["driver"] = driver_case(mesh)
    finally:
        dist.destroy_process_group()
    res["cli"] = _launched_cli(rank, world, port, out_dir)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reference_on_its_flat_plane(monkeypatch):
    """The reference's drivers on their flat plane, with plain versions."""
    import repro.launch.mesh as jmesh
    import repro.serving.batch_driver as jbd
    monkeypatch.setattr(jmesh, "make_fabric_mesh", lambda n: None)
    monkeypatch.setattr(jbd, "TieredKV",
                        functools.partial(jbd.TieredKV, use_kernel=False))


def _answers_while_the_ranks_run():
    """Compute (and cache) the reference's and the flat plane's answers
    while the ranks run; a case that fails here fails again in its own
    test."""
    with pytest.MonkeyPatch.context() as m:
        _reference_on_its_flat_plane(m)
        for fn, names in ((reference_consume, CONSUME),
                          (flat_consume, CONSUME),
                          (reference_sweep, SWEEPS), (flat_sweep, SWEEPS),
                          (reference_engine, ENGINES),
                          (flat_engine, ENGINES)):
            for name in names:
                with contextlib.suppress(Exception):
                    fn(name)
        for fn in (reference_driver, flat_driver, flat_batch):
            with contextlib.suppress(Exception):
                fn()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("fabric")
    ctx = mp.start_processes(_rank_main, args=(WORLD, str(d / "store"),
                                               str(d), _free_port()),
                             nprocs=WORLD, start_method="spawn", join=False)
    try:
        _answers_while_the_ranks_run()
    finally:
        while not ctx.join():
            pass
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture
def reference(monkeypatch):
    _reference_on_its_flat_plane(monkeypatch)


def _same(a, b, where):
    """The port's ``a`` and ``b``, bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.numpy().tobytes() == b.numpy().tobytes(), where
    else:
        assert a == b, where


def _same_ref(j, t, where, keys=None):
    """The reference's ``j`` and the port's ``t``, bit for bit (over the
    reference's ``keys`` of a dict where given, else the same keys)."""
    if isinstance(j, dict):
        if keys is None:
            assert set(j) == set(t), where
        for k in keys or j:
            _same_ref(j[k], t[k], f"{where}.{k}")
        return
    j = np.asarray(j)
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    assert j.dtype == t.dtype and j.shape == t.shape, where
    assert j.tobytes() == t.tobytes(), where


@functools.lru_cache(maxsize=None)
def reference_consume(name):
    import jax.numpy as jnp

    from repro.fabric import chaos as jc
    from repro.paging import lifecycle as jlc
    from repro.paging import prefetch_serving as jps
    from repro.paging import sharded_pool as jsp
    c = CONSUME[name]
    cold, sched = consume_inputs()
    return jsp.sharded_multi_stream_consume(
        {k: jnp.asarray(v) for k, v in cold.items()}, jnp.asarray(sched),
        jps.PrefetchedStream(**CONSUME_GEOM),
        jsp.ShardedPoolCfg(**consume_fabric(name)),
        chaos=jc.ChaosSpec(**c["chaos"]) if "chaos" in c else None,
        migration=(jlc.MigrationCfg(**c["migration"]) if "migration" in c
                   else None))


@functools.lru_cache(maxsize=None)
def reference_sweep(name):
    """The reference's run of :func:`sweep_case` (``use_kernel=False``,
    the attention through its plain version): ``(state, infos, out,
    resident)``."""
    import jax.numpy as jnp

    from repro.paging import sharded_pool as jsp
    from repro.paging import tiered_kv as jt
    c = SWEEPS[name]
    cold, rows, q, lengths = sweep_inputs()
    cold = {k: jnp.asarray(v) for k, v in cold.items()}
    rows = jnp.asarray(rows)
    n_pages = B * NPPS
    n_slots = tt.tiered_min_slots(NPPS, tt.TieredKV(n_pages, 1, PS, HKV, DH,
                                                    **SWEEP_KW))
    geom = jt.TieredKV(n_pages, n_slots, PS, HKV, DH, use_kernel=False,
                       **SWEEP_KW)
    fab = jsp.ShardedPoolCfg(**sweep_fabric(name))
    life = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in sweep_lifecycle(name).items()}
    st = jt.tiered_init(geom, B, jnp.float32)
    infos = []
    for _ in range(2):
        st, info = jt.tiered_sweep(st, cold, rows, geom,
                                   async_datapath=c["async_dp"], fabric=fab,
                                   **life)
        infos.append(info)
        st = jt.tiered_invalidate(st, rows[:, 2:3])
    st, out, info, ok = jt.tiered_decode_step(
        st, cold, jnp.asarray(q), rows, jnp.asarray(lengths), geom,
        async_datapath=c["async_dp"], fabric=fab, attn_kernel="ref", **life)
    infos.append(info)
    return st, infos, np.asarray(out), bool(ok)


@functools.lru_cache(maxsize=None)
def reference_engine(name):
    from repro.paging import lifecycle as jlc
    from repro.serving.engine import ServeConfig as JCfg
    from repro.serving.engine import ServingEngine as JEngine
    kw = dict(ENGINES[name])
    if "migration" in kw:
        kw["migration"] = jlc.MigrationCfg(**kw["migration"])
    kw["attn_kernel"] = "ref"          # the same integers, plain attention
    ex = RecordingExecutor()
    eng = JEngine(JCfg(use_kernel=False, **kw), ex)
    return _engine_result(eng, eng.run(), ex)


@functools.lru_cache(maxsize=None)
def reference_driver():
    import jax.numpy as jnp

    import repro.serving.batch_driver as jbd
    from repro import configs as jcfg
    k, v = driver_kv()
    state = {"blocks": ({"k": jnp.asarray(k[None]),
                         "v": jnp.asarray(v[None])},)}
    return _traced(lambda trace: jbd.serve_batch_tiered(
        jcfg.get_smoke_config(DRIVER_ARCH), state, DRIVER_ARGS, DRIVER_NB,
        DRIVER_P, DRIVER_P + DRIVER_G, trace_path=trace))


def test_each_rank_holds_one_home_shard_of_a_gloo_group(ranks):
    assert [r["plane"] for r in ranks] == [(i, "gloo")
                                           for i in range(WORLD)]
    for r in ranks:
        ring = r["ring"]
        assert ring["route"] == "gloo" and ring["hops"] > 0
        assert ring["bytes"] > 0


@functools.lru_cache(maxsize=None)
def flat_consume(name):
    return consume_case(name)


@functools.lru_cache(maxsize=None)
def flat_sweep(name):
    return sweep_case(name)


@functools.lru_cache(maxsize=None)
def flat_engine(name):
    return engine_case(name)


@functools.lru_cache(maxsize=None)
def flat_driver():
    return driver_case()


@functools.lru_cache(maxsize=None)
def flat_batch():
    """``_main_batch`` on :data:`BATCH` through the CLI in this world of
    one: the flat plane."""
    def run(trace):
        with contextlib.redirect_stdout(io.StringIO()):
            return tserve.main(BATCH + ["--trace", trace])
    return _traced(run)


def _check_consume(want, got, ranks_got):
    """Every rank's consume against the reference's and the flat plane's
    (checksums, ``info`` and the state, bit for bit)."""
    jst, jsums, jinfo = want
    st, sums, info = got
    for mst, msums, minfo in ranks_got:
        _same_ref(jsums, msums, "sums")
        _same_ref(jinfo, minfo, "info")
        _same_ref(jst, mst, "state")
        _same(sums, msums, "sums")
        _same(info, minfo, "info")
        _same(st, mst, "state")


@pytest.mark.parametrize("name", list(CONSUME))
def test_mesh_consume_is_the_flat_plane_bitwise(ranks, name):
    st, sums, info = got = flat_consume(name)
    assert ("est_q" in info) == (name == "chaos")
    assert ("tier" in st) == (name == "lifecycle")
    _check_consume(reference_consume(name), got,
                   [r["consume"][name] for r in ranks])


SWEEP_GROUPS = ("leap", "pool_meta", "ring", "hot")


def _check_sweep(want, flat_run, ranks_got):
    """Every rank's sweeps against the reference's and the flat plane's
    (``info`` and the state bit for bit; the attention bitwise the flat
    pool's and within 2e-5 of the reference's)."""
    jst, jinfos, jout, jok = want
    st, infos, out, ok, flat = flat_run
    assert jok and ok and torch.equal(out, flat)
    np.testing.assert_allclose(out.numpy(), jout, atol=2e-5, rtol=2e-5)
    for mst, minfos, mout, mok, _ in ranks_got:
        assert mok and torch.equal(mout, flat)
        assert not mout.isnan().any()
        for i, (j, f, m) in enumerate(zip(jinfos, infos, minfos)):
            _same_ref(j, m, f"info {i}")
            _same(f, m, f"info {i}")
        for g in SWEEP_GROUPS:
            _same_ref(jst[g], mst[g], g, keys=list(jst[g]))
        _same(st, mst, "state")


@pytest.mark.parametrize("name", list(SWEEPS))
def test_mesh_tiered_sweep_is_the_flat_plane_bitwise(ranks, name):
    _check_sweep(reference_sweep(name), flat_sweep(name),
                 [r["sweep"][name] for r in ranks])


def test_each_rank_reads_only_its_own_slice(ranks):
    """Every page homed elsewhere is NaN in a rank's copy of the pool; the
    ring brings each from its home rank, so the results stay bitwise."""
    _check_consume(reference_consume("chaos"), flat_consume("chaos"),
                   [r["consume_poisoned"] for r in ranks])
    _check_sweep(reference_sweep("async"), flat_sweep("async"),
                 [r["sweep_poisoned"] for r in ranks])


def test_every_rank_holds_the_same_integers(ranks):
    first = ranks[0]
    for r in ranks[1:]:
        for name in CONSUME:
            _same(first["consume"][name][2], r["consume"][name][2], name)
            for g in ("pool_meta", "ring", "leap"):
                _same(first["consume"][name][0][g], r["consume"][name][0][g],
                      f"{name}.{g}")
        for name in SWEEPS:
            for a, b in zip(first["sweep"][name][1], r["sweep"][name][1]):
                _same(a, b, name)
        assert r["ring"]["hops"] == first["ring"]["hops"]
        assert r["ring"]["bytes"] == first["ring"]["bytes"]


def _ints(rep, timing):
    return {k: v for k, v in rep.items() if k not in timing}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_on_the_mesh_plane_is_the_flat_run(ranks, reference, name):
    flat = flat_engine(name)
    want = reference_engine(name)
    assert not flat["mesh"]
    assert flat["report"]["tiered_equiv_ok"]
    assert flat["report"]["trace_totals_ok"]
    assert ("residency" in flat["report"]) == (name == "lifecycle")
    assert _ints(flat["report"], ENGINE_TIMING) == \
        _ints(want["report"], ENGINE_TIMING)
    for r in ranks:
        got = r["engine"][name]
        assert got["mesh"]
        for ref in (want, flat):
            assert _ints(got["report"], ENGINE_TIMING) == \
                _ints(ref["report"], ENGINE_TIMING)
            assert got["events"] == ref["events"]
            assert got["tokens"] == ref["tokens"]
            np.testing.assert_array_equal(got["shard_hist"],
                                          ref["shard_hist"])


def test_batch_driver_on_the_mesh_plane_is_the_reference(ranks, reference):
    """The tiered replay (the batch path's data plane): every rank's report and event log are the reference's and the
    flat run's."""
    want = reference_driver()
    flat = flat_driver()
    assert flat["result"]["tiered_equiv_ok"]
    assert flat["result"]["trace_totals_ok"]
    assert flat["result"]["paged_shards"] == 4
    assert sum(flat["result"]["paged_shard_demand"]) > 0
    for ref in (want, flat):
        for r in ranks:
            got = r["driver"]
            assert set(got["result"]) == set(ref["result"])
            assert _ints(got["result"], DRIVER_TIMING) == \
                _ints(ref["result"], DRIVER_TIMING)
            assert got["events"] == ref["events"]


def test_main_batch_on_the_mesh_plane_is_the_flat_run(ranks):
    """Each launched rank's report (rank 0's trace totals included) and
    rank 0's event log are the flat run's."""
    flat = flat_batch()
    want = _ints(flat["result"], BATCH_TIMING)
    assert want["tiered_equiv_ok"] and want["paged_shards"] == 4
    assert want["trace_totals_ok"]
    assert ranks[0]["cli"]["trace"] == flat["events"]
    for rank, r in enumerate(ranks):
        got = _ints(r["cli"]["report"], BATCH_TIMING)
        if rank:
            want = {k: v for k, v in want.items()
                    if not k.startswith("trace_")}
        assert got == want


def test_the_launched_cli_serves_on_the_mesh_plane(ranks):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.serve ...``, as
    its environment reaches each rank: a wrong ``--shards`` is refused
    before any group starts; the serve rides the ring, rank 0 alone prints
    the report and writes the trace, and every rank's group is down at
    the end."""
    for rank, r in enumerate(ranks):
        cli = r["cli"]
        assert cli["refused"] == (2, False)
        assert cli["hops"] > 0 and cli["torn_down"]
        if rank == 0:
            assert cli["printed"].strip() and cli["trace"]
        else:
            assert cli["printed"] == "" and cli["trace"] is None


def test_a_mismatched_fabric_axis_raises_the_reference_error():
    mesh = types.SimpleNamespace(mesh_dim_names=("fabric",), shape=(2,))
    fab = tsp.ShardedPoolCfg(n_shards=4)
    with pytest.raises(ValueError, match="mesh fabric axis 2 != n_shards 4"):
        tsp.check_fabric_topology(N_PAGES, fab, mesh)
    tsp.check_fabric_topology(
        N_PAGES, fab, types.SimpleNamespace(mesh_dim_names=("fabric",),
                                            shape=(4,)))
    with pytest.raises(ValueError, match="no route"):
        tsp.ring_route("nccl", torch.device("cpu"))
    assert tsp.ring_route("gloo", torch.device("cuda")) == "gloo_staged"
