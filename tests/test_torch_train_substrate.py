"""Port: the training substrate against the JAX package's.

The data pipeline (``SyntheticSource`` / ``MemmapSource`` batches bitwise
the reference's for the same seed, step and host; ``TokenPipeline`` state;
``PrefetchQueue`` order, error and timeout); checkpoints (round trip,
atomic commit, keep-3 GC, bf16 leaves bit for bit, a mismatched tree
refused); ``run_with_restarts`` and ``Watchdog`` on the reference's
fault schedules (the same states, restarts and re-run steps as the
reference's); and the three train routes against the reference functions
they port, values and gradients: ``chunked_ce_loss`` and the attention
train route within 2e-5 (f32; a window, ``Sq`` off a multiple of
``block_q``, an ``S`` that ``n_chunks`` does not divide), the Mamba train
route within 1e-4 (four checkpointed chunks). Gradients are held to the
same bounds relative to each one's largest magnitude. Inputs come from
numpy seeds.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import data as jdata  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import tree_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.runtime import (Watchdog, run_with_restarts)  # noqa: E402

F32_TOL, MAMBA_TOL = 2e-5, 1e-4


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,host", [(0, 0, 0), (1, 7, 0), (3, 2, 5)])
def test_synthetic_batches_are_the_reference_bits(seed, step, host):
    j = jdata.SyntheticSource(512, seed).batch(step, host, 3, 16)
    t = tdata.SyntheticSource(512, seed).batch(step, host, 3, 16)
    assert t.dtype == j.dtype and np.array_equal(t, j)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_memmap_batches_are_the_reference_bits(tmp_path, dtype):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(dtype).tofile(
        path)
    js = jdata.MemmapSource(str(path), 1000, dtype)
    ts = tdata.MemmapSource(str(path), 1000, dtype)
    for step, host in ((0, 0), (3, 1), (11, 2)):
        assert np.array_equal(ts.batch(step, host, 4, 32),
                              js.batch(step, host, 4, 32))


def test_token_pipeline_steps_and_state_as_the_reference():
    jp = jdata.make_pipeline(512, 8, 16, n_hosts=2, host_id=1, seed=4)
    tp = tdata.make_pipeline(512, 8, 16, n_hosts=2, host_id=1, seed=4)
    assert tp.rows == jp.rows == 4
    for _ in range(3):
        jb, tb = next(jp), next(tp)
        assert jb.keys() == tb.keys()
        assert all(np.array_equal(jb[k], tb[k]) for k in jb)
    assert tp.state_dict() == jp.state_dict() == {"step": 3}
    tp.load_state_dict({"step": 1})
    assert np.array_equal(next(tp)["tokens"], jp.peek(1)["tokens"])


def test_prefetch_queue_order_errors_and_timeout():
    q = tdata.PrefetchQueue(lambda i: i * i, depth=2, timeout=5.0)
    try:
        assert [q.get() for _ in range(6)] == [i * i for i in range(6)]
    finally:
        q.stop()

    def boom(i):
        if i == 2:
            raise ValueError("bad shard")
        return i

    q = tdata.PrefetchQueue(boom, depth=4, timeout=5.0)
    try:           # the producer's error surfaces at the next get()
        deadline = time.monotonic() + 5.0
        while q._exc is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(ValueError, match="bad shard"):
            q.get()
    finally:
        q.stop()
    gate = threading.Event()
    q = tdata.PrefetchQueue(lambda i: gate.wait(10.0), depth=1, timeout=0.1)
    try:
        with pytest.raises(TimeoutError, match="straggler"):
            q.get()
    finally:
        gate.set()
        q.stop()


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    bf = torch.randn((5, 7), generator=g).to(torch.bfloat16)
    bf[0, :3] = torch.tensor([float("nan"), float("inf"), -0.0])
    return {"params": {"w": torch.randn((3, 4), generator=g), "b": bf},
            "opt": {"m": [torch.randn((2,), generator=g),
                          torch.arange(6, dtype=torch.int32)]}}


def _zeros_like(tree):
    from repro_torch.checkpoint.checkpoint import flatten
    out = _tree(99)
    for (_, t), (_, src) in zip(flatten(out), flatten(tree)):
        t.copy_(torch.zeros_like(src))
    return out


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_checkpoint_round_trip_bf16_bit_exact_and_manifest(tmp_path):
    from repro_torch.checkpoint.checkpoint import flatten
    tree = _tree(0)
    path = save_checkpoint(str(tmp_path), 3, tree, {"data_step": 3})
    assert path.endswith("step_00000003")
    man = json.loads((tmp_path / "step_00000003" / "manifest.json")
                     .read_text())
    assert man["step"] == 3 and man["n_leaves"] == 4
    assert man["extras"] == {"data_step": 3}
    assert [e["name"] for e in man["index"]] == [
        "params.w", "params.b", "opt.m.0", "opt.m.1"]
    assert man["index"][1]["dtype"] == "bfloat16"
    like = _zeros_like(tree)
    got, extras = restore_checkpoint(str(tmp_path), 3, like)
    assert got is like and extras == {"data_step": 3}
    for (_, a), (_, b) in zip(flatten(got), flatten(tree)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    bad = _tree(0)
    bad["params"]["w"] = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="does not fit"):
        restore_checkpoint(str(tmp_path), 3, bad)


def test_checkpoint_commit_is_atomic_and_keeps_three(tmp_path):
    d = str(tmp_path)
    assert latest_step(d + "/none") is None
    (tmp_path / "step_00000009.tmp").mkdir()     # a save cut mid-write
    assert latest_step(d) is None
    ck = AsyncCheckpointer(d, keep=3)
    tree = _tree(1)
    for step in (2, 4, 6, 8, 10):
        ck.save(step, tree, {"data_step": step})
        saved = tree["params"]["w"].clone()
        tree["params"]["w"].add_(1.0)       # the snapshot was taken
    ck.wait()
    assert latest_step(d) == 10
    assert sorted(p.name for p in tmp_path.iterdir()
                  if not p.name.endswith(".tmp")) == [
        "step_00000006", "step_00000008", "step_00000010"]
    like = _zeros_like(tree)
    restore_checkpoint(d, 10, like)
    assert torch.equal(like["params"]["w"], saved)


# --------------------------------------------------------------------------
# fault tolerance: the reference's schedules, the reference's outcomes
# --------------------------------------------------------------------------
def _drive(run, n_steps, save_every, kills, max_restarts):
    ckpt, seen, calls = [None], [], []
    todo = sorted(kills, reverse=True)

    def one(state, step):
        seen.append(step)
        if todo and step == todo[-1]:
            todo.pop()
            raise RuntimeError(f"node died at step {step}")
        return (state * 6364136223846793005 + step + 1) % (1 << 63)

    def save(state, step):
        ckpt[0] = (state, step)

    try:
        out = run(lambda: 1, one, save, lambda: ckpt[0], n_steps=n_steps,
                  save_every=save_every, max_restarts=max_restarts,
                  on_restart=calls.append)
    except RuntimeError as e:
        out = str(e)
    return out, seen, calls, ckpt[0]


def test_run_with_restarts_matches_the_reference():
    rng = np.random.default_rng(97)
    for _ in range(30):
        n_steps = int(rng.integers(1, 40))
        save_every = int(rng.integers(1, 10))
        kills = [int(rng.integers(0, n_steps))
                 for _ in range(int(rng.integers(0, 4)))]
        for max_restarts in (len(kills), len(kills) - 1):
            args = (n_steps, save_every, kills, max(0, max_restarts))
            assert _drive(run_with_restarts, *args) == \
                _drive(jft.run_with_restarts, *args)


def test_watchdog_fires_on_stall_and_stops_clean():
    fired = threading.Event()
    wd = Watchdog(timeout=0.05, on_stall=fired.set).start()
    assert fired.wait(2.0) and wd.stalled
    wd.stop()
    assert not wd._thread.is_alive()
    wd = Watchdog(timeout=0.2).start()
    for _ in range(5):
        time.sleep(0.04)
        wd.beat()
    wd.stop()
    assert not wd.stalled and not wd._thread.is_alive()


# --------------------------------------------------------------------------
# the train routes against the reference functions, values and gradients
# --------------------------------------------------------------------------
def _close(got, want, tol, what=""):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


def _check_vjp(jfn, tfn, args, tol):
    """Value and every input's gradient of ``sum(f(*args) * w)`` (a
    seeded ``w``), reference against port."""
    out = np.asarray(jfn(*map(jnp.asarray, args)))
    w = np.random.default_rng(5).standard_normal(out.shape).astype(
        np.float32)
    jv, jg = jax.value_and_grad(
        lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*targs)
    _close(tout.detach().numpy(), out, tol, "value")
    (tout * torch.from_numpy(w)).sum().backward()
    for i, (t, g) in enumerate(zip(targs, jg)):
        _close(t.grad.numpy(), g, tol, f"grad {i}")


@pytest.mark.parametrize("B,S,D,V,n_chunks", [
    (2, 12, 16, 40, 8),        # 8 does not divide 12: 6 chunks
    (3, 16, 8, 30, 0),         # the auto rule: 8 chunks
    (1, 7, 8, 20, 0),          # S prime: 7 chunks of one
])
def test_chunked_ce_loss_matches_the_reference(B, S, D, V, n_chunks):
    rng = np.random.default_rng(S)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    t = rng.integers(0, V, (B, S)).astype(np.int32)
    m = (rng.random((B, S)) > 0.25).astype(np.float32)
    jfn = lambda h_, w_: jlayers.chunked_ce_loss(h_, w_, jnp.asarray(t),
                                                 jnp.asarray(m), n_chunks)
    tfn = lambda h_, w_: tlayers.chunked_ce_loss(
        h_, w_, torch.from_numpy(t), torch.from_numpy(m), n_chunks)
    _check_vjp(jfn, tfn, [h, w], F32_TOL)


@pytest.mark.parametrize("Sq,Hq,Hkv,dh,window,block_q,block_k", [
    (32, 4, 2, 16, 0, 8, 8),       # 4 query chunks x 4 key blocks, GQA
    (24, 4, 4, 8, 5, 16, 16),      # window 5; 16 divides neither: 8 and 8
    (20, 6, 2, 8, 0, 1024, 512),   # the defaults, halved to 4
    (17, 2, 1, 8, 3, 4, 4),        # S prime: chunks and blocks of one
])
def test_train_attention_matches_the_reference(Sq, Hq, Hkv, dh, window,
                                               block_q, block_k):
    rng = np.random.default_rng(Sq)
    q = rng.standard_normal((2, Sq, Hq, dh)).astype(np.float32)
    k = rng.standard_normal((2, Sq, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((2, Sq, Hkv, dh)).astype(np.float32)
    kw = dict(causal=True, window=window, block_q=block_q, block_k=block_k)
    _check_vjp(lambda *a: jattn.blocked_attention(*a, **kw),
               lambda *a: tattn.train_attention(*a, **kw), [q, k, v],
               F32_TOL)


def test_train_attention_bidirectional_matches_the_reference():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 12, 2, 8)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=False, block_q=4, block_k=4)
    _check_vjp(lambda *a: jattn.blocked_attention(*a, **kw),
               lambda *a: tattn.train_attention(*a, **kw), [q, k, v],
               F32_TOL)


@pytest.mark.parametrize("S", [16, 260])
def test_mamba_train_route_matches_the_reference(S):
    """S = 260: four chunks of 65 (``_pick_chunk``); 16: one."""
    D, N = 16, 4
    p, _ = jmamba.mamba_init(jax.random.PRNGKey(S), D, 2, N, 4, jnp.float32)
    names = sorted(p)
    x = np.random.default_rng(S).standard_normal((2, S, D)).astype(
        np.float32)
    leaves = [np.asarray(p[n]) for n in names]
    jfn = lambda x_, *ls: jmamba.apply_mamba(dict(zip(names, ls)), x_, N)
    tfn = lambda x_, *ls: tmamba.apply_mamba_train(dict(zip(names, ls)), x_,
                                                   N)
    assert tmamba._pick_chunk(S) == jmamba._pick_chunk(S)
    _check_vjp(jfn, tfn, [x, *leaves], MAMBA_TOL)


def test_forward_only_kernels_refuse_grad_inputs_on_the_cpu():
    """The wrappers raise under grad mode for an input that requires grad
    (the card test does the same on CUDA); without grad mode, or with no
    input requiring grad, they run as before."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    rng = np.random.default_rng(0)
    q, k, v = (tree_from_numpy(rng.standard_normal((1, 8, 2, 8)).astype(
        np.float32), "cpu") for _ in range(3))
    ss = [torch.rand((1, 6, 4)), torch.randn((1, 6, 3)),
          torch.randn((1, 6, 3)), torch.randn((1, 6, 4)),
          -torch.rand((4, 3))]
    for fn, args, route in (
            (flash_attention, (q, k, v), "train_attention"),
            (selective_scan, ss, "apply_mamba_train")):
        want = fn(*args)
        for i in range(len(args)):
            a = list(args)
            a[i] = a[i].clone().requires_grad_(True)
            with pytest.raises(RuntimeError, match=route):
                fn(*a)
            with torch.no_grad():
                assert torch.equal(fn(*a), want)
