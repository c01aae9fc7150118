"""Port, on the card: each CUDA kernel against its plain version.

Every test here carries the ``cuda`` marker and skips without a GPU. The
file imports neither JAX nor the reference, so it runs on a machine with
PyTorch alone:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gather_pages import ops as kg  # noqa: E402
from repro_torch.kernels.paged_attention import ops as ka  # noqa: E402

SHAPES = [  # B/S, Hq, Hkv, dh, page, npps: GQA, MHA, MQA, serving path
    (2, 8, 2, 64, 16, 4),
    (1, 4, 4, 32, 8, 8),
    (3, 4, 1, 128, 32, 2),
    (8, 16, 2, 128, 16, 129),
    # through kernel.split_pages (P pages a split, n splits):
    (8, 16, 2, 128, 16, 2048),   # qwen2.5-3b at its 32K context: P 121, 17
    (4, 32, 8, 128, 16, 65),     # jamba's GQA group, G = 4: P 8, 9
    (64, 64, 8, 128, 16, 16),    # B * Hkv fills the card: one split
    (2, 8, 2, 64, 16, 37),       # npps off a multiple of P: P 2, 19
    (2, 32, 2, 64, 16, 9),       # G = 16, two blocks of heads: P 2, 5
    (4, 40, 8, 128, 16, 9),      # llama4's G = 5: 3 idle rows of 8
    (4, 32, 8, 120, 16, 65),     # h2o-danube3's dh 120: off mma.sync
    (4, 16, 16, 64, 16, 65),     # seamless-m4t's MHA, G = 1
]
# head dims whose bf16 rows are 8, 12 and 6 bytes: the async kernel's
# 8-byte, 4-byte and element-wise copy paths
ODD_ROWS = [(2, 4, 2, 4, 8, 3), (3, 4, 2, 6, 8, 3), (2, 2, 1, 3, 4, 5)]
# rows over 512 bytes, where a lane holds two or four chunks of a row: f32 at
# stablelm-12b's dh 160 (640 bytes), f32 dh 256 / bf16 dh 512 (1,024
# bytes), f32 dh 512 (2,048 bytes, the widest taken)
WIDE_ROWS = [(2, 32, 8, 160, 16, 9), (2, 8, 2, 256, 8, 5),
             (2, 4, 2, 512, 4, 3)]


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the card)")
    return torch.device("cuda")


def _has_valid_token(table, n_valid, lengths, page_size):
    """Rows with at least one unmasked token. A row with none is 0 from
    the kernels and the uniform average of V from the plain versions (an
    all-masked softmax), as in the reference; only live rows compare."""
    ok = (table >= 0) & (table < n_valid)
    pos = torch.arange(table.shape[1] * page_size, device=table.device)
    tok = ok.repeat_interleave(page_size, 1) & (pos[None] < lengths[:, None])
    return tok.any(1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
@pytest.mark.parametrize("row", [(16, 2, 128), (3, 7), (5000,), (8192,)])
def test_cuda_gather_kernels_bytes_exact(cuda, dtype, row):
    """Rows of 8 KB (bf16 (16, 2, 128), uint8 (8192,)), of several 8 KB
    tiles, unaligned ones; K = 1, 33, and 600, more tiles than one block
    of the async kernel takes."""
    g = torch.Generator(device=cuda).manual_seed(0)
    pool = (torch.randn((40,) + row, generator=g, device=cuda) * 50).to(dtype)
    for K in (33, 1, 600):
        idx = torch.randint(-3, 45, (K,), generator=g, device=cuda,
                            dtype=torch.int32)
        want = kg.gather_pages(pool, idx, use_kernel=False)
        for fn in (kg.gather_pages, kg.gather_pages_async):
            got = fn(pool, idx)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (K, fn.__name__)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,dh,ps,npps", SHAPES + WIDE_ROWS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_attention_kernels_vs_plain(cuda, B, Hq, Hkv, dh, ps, npps,
                                         dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(1)
    n_pages = B * npps + 3
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q = rnd(B, 1, Hq, dh)
    kp, vp = rnd(n_pages, ps, Hkv, dh), rnd(n_pages, ps, Hkv, dh)
    pt = torch.randint(0, n_pages, (B, npps), generator=g, device=cuda,
                       dtype=torch.int32)
    pt[0, 0], pt[-1, -1] = -1, n_pages + 5
    ln = torch.randint(1, ps * npps + 1, (B,), generator=g, device=cuda,
                       dtype=torch.int32)
    got = ka.paged_attention(q, kp, vp, pt, ln)
    want = ka.paged_attention(q, kp, vp, pt, ln, use_kernel=False)
    torch.cuda.synchronize()
    live = _has_valid_token(pt, n_pages, ln, ps)
    assert (got[live].float() - want[live].float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        assert _bf16_ulp_ratio(got[live], want[live]) <= 1.0
    n_slots = npps + 2
    kh, vh = rnd(B, n_slots, ps, Hkv, dh), rnd(B, n_slots, ps, Hkv, dh)
    st = torch.randint(-1, n_slots + 1, (B, npps), generator=g, device=cuda,
                       dtype=torch.int32)
    hot = ka.paged_attention_hot_slots(q, kh, vh, st, ln)
    want = ka.paged_attention_hot_slots(q, kh, vh, st, ln, use_kernel=False)
    base = torch.arange(B, dtype=torch.int32, device=cuda)[:, None] * n_slots
    gt = torch.where((st >= 0) & (st < n_slots), st + base,
                     torch.full_like(st, -1))
    flat = ka.paged_attention(q, kh.reshape(-1, ps, Hkv, dh),
                              vh.reshape(-1, ps, Hkv, dh), gt, ln)
    torch.cuda.synchronize()
    live = _has_valid_token(st, n_slots, ln, ps)
    assert (hot[live].float() - want[live].float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        assert _bf16_ulp_ratio(hot[live], want[live]) <= 1.0
    assert torch.equal(hot, flat)                 # fused == flat, bitwise


@pytest.mark.cuda
@pytest.mark.parametrize("S,Hq,Hkv,dh,ps,npps", SHAPES + ODD_ROWS + WIDE_ROWS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_async_hot_slots_vs_plain_and_bitwise(cuda, S, Hq, Hkv, dh, ps,
                                                    npps, dtype, tol):
    """The cp.async kernel against the plain version on poisoned tables
    (and, with more than one stream, an all-masked row and a length-0
    row), and bitwise equal to the sync hot-slot and flat kernels."""
    g = torch.Generator(device=cuda).manual_seed(2)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    n_slots = npps + 2
    q = rnd(S, 1, Hq, dh)
    kh, vh = rnd(S, n_slots, ps, Hkv, dh), rnd(S, n_slots, ps, Hkv, dh)
    st = torch.randint(-1, n_slots + 1, (S, npps), generator=g, device=cuda,
                       dtype=torch.int32)
    st[0, 0] = n_slots + 3
    ln = torch.randint(1, ps * npps + 1, (S,), generator=g, device=cuda,
                       dtype=torch.int32)
    if S > 1:
        st[-1] = -1                                   # all masked
        ln[1] = 0                                     # nothing to attend
    got = ka.paged_attention_hot_slots(q, kh, vh, st, ln, async_copy=True)
    sync = ka.paged_attention_hot_slots(q, kh, vh, st, ln)
    want = ka.paged_attention_hot_slots(q, kh, vh, st, ln, use_kernel=False)
    base = torch.arange(S, dtype=torch.int32, device=cuda)[:, None] * n_slots
    gt = torch.where((st >= 0) & (st < n_slots), st + base,
                     torch.full_like(st, -1))
    flat = ka.paged_attention(q, kh.reshape(-1, ps, Hkv, dh),
                              vh.reshape(-1, ps, Hkv, dh), gt, ln)
    torch.cuda.synchronize()
    live = _has_valid_token(st, n_slots, ln, ps)
    if live.any():
        err = (got[live].float() - want[live].float()).abs().max().item()
        assert err <= tol
        if dtype == torch.bfloat16:
            assert _bf16_ulp_ratio(got[live], want[live]) <= 1.0
    assert torch.equal(got, sync) and torch.equal(got, flat)
    assert not got[~live].any()                   # masked rows are 0


#: the split's edges at the model serve's shape (P 2, 33 splits) and the
#: synthetic serve's (P 8, 17 splits)
SPLIT_EDGES = [(4, 16, 2, 128, 16, 65), (8, 16, 2, 128, 16, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,Hq,Hkv,dh,ps,npps", SPLIT_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_split_edges(cuda, S, Hq, Hkv, dh, ps, npps, dtype):
    """Row 0's table masks every page of its split 1; row 1's length ends
    inside its split 0, so its later splits are all past it; row 2's ends
    inside its last page. The three kernels against the plain version, and
    async == sync == flat bitwise."""
    from repro_torch.kernels.paged_attention.kernel import split_pages
    pps, n_split = split_pages(S, Hkv, npps)
    assert 2 <= pps < npps and n_split > 2
    g = torch.Generator(device=cuda).manual_seed(8)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    n_slots = npps + 2
    q = rnd(S, 1, Hq, dh)
    kh, vh = rnd(S, n_slots, ps, Hkv, dh), rnd(S, n_slots, ps, Hkv, dh)
    st = torch.stack([torch.randperm(n_slots, generator=g, device=cuda)[:npps]
                      for _ in range(S)]).to(torch.int32)
    st[0, pps:2 * pps] = -1
    ln = torch.full((S,), npps * ps, dtype=torch.int32, device=cuda)
    ln[1] = ps * (pps - 1) + 3
    ln[2] = npps * ps - 5
    got = ka.paged_attention_hot_slots(q, kh, vh, st, ln, async_copy=True)
    sync = ka.paged_attention_hot_slots(q, kh, vh, st, ln)
    want = ka.paged_attention_hot_slots(q, kh, vh, st, ln, use_kernel=False)
    base = torch.arange(S, dtype=torch.int32, device=cuda)[:, None] * n_slots
    gt = torch.where(st >= 0, st + base, torch.full_like(st, -1))
    flat = ka.paged_attention(q, kh.reshape(-1, ps, Hkv, dh),
                              vh.reshape(-1, ps, Hkv, dh), gt, ln)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert (sync - want).abs().max().item() <= 2e-5
    else:
        assert _bf16_ulp_ratio(sync, want) <= 1.0
    assert torch.equal(sync, flat) and torch.equal(got, sync)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,ps,tensor_cores", [
    (torch.bfloat16, 128, 16, True), (torch.bfloat16, 64, 16, True),
    (torch.float32, 128, 16, False), (torch.bfloat16, 128, 8, False),
    (torch.bfloat16, 96, 16, False)])
def test_cuda_attention_route_counter_and_split_record(cuda, dtype, dh, ps,
                                                        tensor_cores):
    """bf16 at page 16 and dh 64 / 128 takes the tensor-core route and
    raises its counter once a launch, for each of the three kernels;
    every other call takes the CUDA-core route and does not. Each launch
    records the split it passed, the one split_pages gives its shape."""
    from repro_torch.kernels.paged_attention import kernel as pk
    g = torch.Generator(device=cuda).manual_seed(9)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    S, Hq, Hkv, npps = 4, 16, 2, 65
    n_slots = npps + 1
    q = rnd(S, 1, Hq, dh)
    kh, vh = rnd(S, n_slots, ps, Hkv, dh), rnd(S, n_slots, ps, Hkv, dh)
    st = torch.stack([torch.randperm(n_slots, generator=g, device=cuda)[:npps]
                      for _ in range(S)]).to(torch.int32)
    ln = torch.full((S,), npps * ps - 3, dtype=torch.int32, device=cuda)
    base = torch.arange(S, dtype=torch.int32, device=cuda)[:, None] * n_slots
    split = dict(zip(("pages_per_split", "n_split"),
                     pk.split_pages(S, Hkv, npps)),
                 tensor_cores=tensor_cores)
    assert pk.tensor_core_route(dtype, ps, dh) == tensor_cores
    for name, call in (
            ("paged_attention", lambda: ka.paged_attention(
                q, kh.reshape(-1, ps, Hkv, dh), vh.reshape(-1, ps, Hkv, dh),
                st + base, ln)),
            ("paged_attention_hot_slots",
             lambda: ka.paged_attention_hot_slots(q, kh, vh, st, ln)),
            ("paged_attention_hot_slots_async",
             lambda: ka.paged_attention_hot_slots(q, kh, vh, st, ln,
                                                  async_copy=True))):
        n0, t0 = pk._build.counts()[name], pk.paged_attention_mma_launches.n
        call()
        torch.cuda.synchronize()
        assert pk._build.counts()[name] == n0 + 1
        assert pk.paged_attention_mma_launches.n == t0 + int(tensor_cores)
        assert pk.last_launch[name] == split


@pytest.mark.cuda
def test_cuda_attention_group_of_five_on_the_tensor_cores(cuda):
    """llama4-maverick's decode shape (40 query heads over 8 KV heads of
    128, bf16, page 16): its group of 5 leaves 3 idle rows in the
    tensor-core route's block of 8. All three kernels take that route,
    match the plain version, and hot-slot == flat == async bitwise."""
    from repro_torch.kernels.paged_attention import kernel as pk
    g = torch.Generator(device=cuda).manual_seed(10)
    S, Hq, Hkv, dh, ps, npps = 4, 40, 8, 128, 16, 9
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(
        torch.bfloat16)
    n_slots = npps + 2
    q = rnd(S, 1, Hq, dh)
    kh, vh = rnd(S, n_slots, ps, Hkv, dh), rnd(S, n_slots, ps, Hkv, dh)
    st = torch.stack([torch.randperm(n_slots, generator=g, device=cuda)[:npps]
                      for _ in range(S)]).to(torch.int32)
    st[1, 2] = -1
    ln = torch.tensor([npps * ps, 5, npps * ps - 7, 70], dtype=torch.int32,
                      device=cuda)
    base = torch.arange(S, dtype=torch.int32, device=cuda)[:, None] * n_slots
    gt = torch.where(st >= 0, st + base, torch.full_like(st, -1))
    t0 = pk.paged_attention_mma_launches.n
    flat = ka.paged_attention(q, kh.reshape(-1, ps, Hkv, dh),
                              vh.reshape(-1, ps, Hkv, dh), gt, ln)
    hot = ka.paged_attention_hot_slots(q, kh, vh, st, ln)
    got = ka.paged_attention_hot_slots(q, kh, vh, st, ln, async_copy=True)
    want = ka.paged_attention_hot_slots(q, kh, vh, st, ln, use_kernel=False)
    torch.cuda.synchronize()
    assert pk.paged_attention_mma_launches.n == t0 + 3
    assert _bf16_ulp_ratio(hot, want) <= 1.0
    assert torch.equal(hot, flat) and torch.equal(got, hot)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_unaligned_views(cuda, dtype):
    """q and the pools as views one element into their storage (2-byte
    aligned in bf16, where the tensor-core route stages pages element by
    element; 4-byte in f32): the three kernels against the plain version,
    and async == sync == flat bitwise."""
    g = torch.Generator(device=cuda).manual_seed(10)

    def rnd(*shape):
        n = 1
        for d in shape:
            n *= d
        buf = torch.randn(n + 1, generator=g, device=cuda).to(dtype)
        return buf[1:].view(shape)

    S, Hq, Hkv, dh, ps, npps = 4, 16, 2, 128, 16, 65
    n_slots = npps + 2
    q = rnd(S, 1, Hq, dh)
    kh, vh = rnd(S, n_slots, ps, Hkv, dh), rnd(S, n_slots, ps, Hkv, dh)
    assert kh.data_ptr() % 4 == (2 if dtype == torch.bfloat16 else 0)
    st = torch.randint(-1, n_slots + 1, (S, npps), generator=g, device=cuda,
                       dtype=torch.int32)
    ln = torch.randint(1, ps * npps + 1, (S,), generator=g, device=cuda,
                       dtype=torch.int32)
    got = ka.paged_attention_hot_slots(q, kh, vh, st, ln, async_copy=True)
    sync = ka.paged_attention_hot_slots(q, kh, vh, st, ln)
    want = ka.paged_attention_hot_slots(q, kh, vh, st, ln, use_kernel=False)
    base = torch.arange(S, dtype=torch.int32, device=cuda)[:, None] * n_slots
    gt = torch.where((st >= 0) & (st < n_slots), st + base,
                     torch.full_like(st, -1))
    flat = ka.paged_attention(q, kh.reshape(-1, ps, Hkv, dh),
                              vh.reshape(-1, ps, Hkv, dh), gt, ln)
    torch.cuda.synchronize()
    live = _has_valid_token(st, n_slots, ln, ps)
    if dtype == torch.float32:
        assert (sync[live] - want[live]).abs().max().item() <= 2e-5
    else:
        assert _bf16_ulp_ratio(sync[live], want[live]) <= 1.0
    assert torch.equal(sync, flat) and torch.equal(got, sync)


@pytest.mark.cuda
def test_cuda_attention_rows_over_2048_bytes_raise(cuda):
    """A K/V row wider than the kernels take (f32 dh 520: 2,080 bytes)
    raises from the wrapper instead of falling back to the plain version."""
    from repro_torch.kernels.paged_attention import kernel as pk
    q = torch.zeros(1, 1, 2, 520, device=cuda)
    kp = torch.zeros(2, 4, 1, 520, device=cuda)
    pt = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    ln = torch.ones(1, dtype=torch.int32, device=cuda)
    n0 = pk.paged_attention_launches.n
    with pytest.raises(ValueError, match="exceed 2048"):
        ka.paged_attention(q, kp, kp, pt, ln)
    assert pk.paged_attention_launches.n == n0


@pytest.mark.cuda
def test_cuda_full_width_decode_step_is_finite(cuda):
    """qwen2.5-3b at full width in bf16 (random weights from a seed):
    a few decode steps give finite logits of the vocabulary's width."""
    from repro_torch import configs
    from repro_torch.models import build_model
    cfg = configs.get_config("qwen2_5_3b")
    model = build_model(cfg, device=cuda, seed=0)
    assert model.dtype == torch.bfloat16
    state = model.init_decode_state(1, 8)
    for t in (1, 2, 3):
        logits, state = model.decode_step(
            torch.tensor([t], device=cuda), state)
    torch.cuda.synchronize()
    assert logits.shape == (1, cfg.vocab_size)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert state["pos"] == 3


def _bf16_ulp_ratio(got, want):
    """Largest |got - want| over one bf16 ulp of the larger magnitude
    (+1e-6): both versions compute in f32 and round once to bf16."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(got), e - 8)
    return ((got - want).abs() / (ulp + 1e-6)).max().item()


SCAN_SHAPES = [  # B, S, di, N; S in ring terms is read by _ring_steps
    (2, 100, 200, 16),
    (1, 1, 5, 8),                            # di 5: rows of 20 bytes
    (3, 130, 128, 4),
    (4, 1024, 8192, 16),                     # jamba's prefill widths
    (2, 1, 64, 16),                          # S = 1
    (2, "stage-1", 96, 16), (2, "stage", 96, 16), (2, "stage+1", 96, 16),
    (1, "wrap", 72, 8),                      # the ring wraps twice and more
    (2, 100, 5, 16), (2, 50, 6, 4),          # di not a multiple of 4
    (2, 37, 8200, 16),                       # 64-channel blocks, ragged edge
    (2, 21, 8195, 8),                        # ... on the cp.async route
    (2, 33, 128, 1), (2, 33, 128, 2),        # N < 4: b / c rows under 16 B
    (2, 33, 128, 8), (1, 20, 64, 32), (1, 20, 64, 64),  # every other N
]
# the shapes whose contiguous views no tensor map takes: rows of dt (f32) or
# of x (bf16) that are not a whole number of 16-byte units apart, or b / c
# rows of N < 4 floats; every other shape takes the TMA route, (1, 1, 5, 8)
# too (one row of each tensor: no stride to describe)
SCAN_CP_ASYNC = {(2, 100, 5, 16), (2, 50, 6, 4), (2, 21, 8195, 8),
                 (2, 33, 128, 1), (2, 33, 128, 2)}


def _ring_steps(S):
    """S of a scan case: a number, or one of a ring stage's time steps less
    one, itself or one more, or (``"wrap"``) enough to wrap the ring more
    than twice, from the ring the kernel is built with."""
    if isinstance(S, int):
        return S
    from repro_torch.kernels.selective_scan.kernel import ring_shape
    tt, stages = ring_shape()
    return {"stage-1": tt - 1, "stage": tt, "stage+1": tt + 1,
            "wrap": 2 * tt * stages + 35}[S]


def _scan_launch(fn, *args, **kw):
    """``fn(*args, **kw)`` and the launches it added on each route:
    ``(out, all routes, TMA route)``."""
    from repro_torch.kernels.selective_scan import kernel as sk
    n0, t0 = sk.selective_scan_launches.n, sk.selective_scan_tma_launches.n
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return (out, sk.selective_scan_launches.n - n0,
            sk.selective_scan_tma_launches.n - t0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_selective_scan_vs_plain(cuda, B, S, di, N, dtype):
    """Bitwise equal to the plain version on every shape (the kernel keeps
    its arithmetic op for op), through the route the shape calls for. In
    bf16 every input is bf16: dt, b, c, a are cast to f32 by ops, x is
    read as bf16."""
    from repro_torch.kernels.selective_scan import selective_scan
    tma = (B, S, di, N) not in SCAN_CP_ASYNC
    S = _ring_steps(S)
    g = torch.Generator(device=cuda).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    dt = torch.nn.functional.softplus(rnd(B, S, di) - 2).to(dtype)
    b, c, x = rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype), \
        rnd(B, S, di).to(dtype)
    a = -torch.exp(rnd(di, N)).to(dtype)
    (y, h), n, n_tma = _scan_launch(selective_scan, dt, b, c, x, a,
                                    return_state=True)
    y0, h0 = selective_scan(dt, b, c, x, a, return_state=True,
                            use_kernel=False)
    assert (n, n_tma) == (1, int(tma))
    assert y.dtype == dtype and h.dtype == torch.float32
    assert torch.equal(y, y0) and torch.equal(h, h0)


SCAN_MODEL_VIEWS = [  # B, S, di, N, dt_rank, x dtype, TMA route
    (4, 1024, 8192, 16, 256, torch.bfloat16, True),  # jamba's bf16 prefill
    (2, 68, 8192, 16, 256, torch.float32, True),     # its f32 check
    (1, 1, 64, 16, 32, torch.bfloat16, True),        # S = 1
    (2, 37, 40, 4, 4, torch.float32, True),          # rows of 48 bytes
    (2, 37, 40, 8, 3, torch.bfloat16, False),        # rows of 76 bytes
    (2, 37, 5, 16, 1, torch.bfloat16, False),        # di 5, b 4 B off
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N,R,xdtype,tma", SCAN_MODEL_VIEWS)
def test_cuda_selective_scan_model_views_bitwise(cuda, B, S, di, N, R,
                                                 xdtype, tma):
    """The inputs as the Mamba mixer hands them over: f32 dt, x in the
    model's dtype, b and c strided views of one [B, S, R + 2N] projection;
    no copy is made, and y and h_final are bitwise the plain version's."""
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.kernels.selective_scan import ops as so
    g = torch.Generator(device=cuda).manual_seed(8)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    dt = torch.nn.functional.softplus(rnd(B, S, di) - 2)
    x = rnd(B, S, di).to(xdtype)
    dbc = rnd(B, S, R + 2 * N)
    b, c = dbc[..., R:R + N], dbc[..., R + N:]
    a = -torch.exp(rnd(di, N))
    views = so._kernel_views(dt, b, c, x, a)
    assert all(v is t for v, t in zip(views, (dt, b, c, x, a)))
    (y, h), n, n_tma = _scan_launch(selective_scan, dt, b, c, x, a,
                                    return_state=True)
    y0, h0 = selective_scan(dt, b, c, x, a, return_state=True,
                            use_kernel=False)
    assert (n, n_tma) == (1, int(tma))
    assert torch.equal(y, y0) and torch.equal(h, h0)


@pytest.mark.cuda
def test_cuda_selective_scan_raises_on_views_it_does_not_take(cuda):
    """The kernel's wrapper raises for a view neither route takes (x with
    a non-unit inner stride, a float16 x) and launches nothing; ops makes
    its explicit copy / cast first and then launches."""
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.kernels.selective_scan import kernel as sk
    g = torch.Generator(device=cuda).manual_seed(9)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    dt, b, c, a = rnd(2, 9, 32).abs(), rnd(2, 9, 8), rnd(2, 9, 8), \
        -rnd(32, 8).abs()
    for x in (rnd(2, 9, 64)[..., ::2], rnd(2, 9, 32).half()):
        n0 = sk.selective_scan_launches.n
        with pytest.raises(ValueError):
            sk.selective_scan_fwd(dt, b, c, x, a)
        assert sk.selective_scan_launches.n == n0
        (y, h), n, _ = _scan_launch(selective_scan, dt, b, c, x, a,
                                    return_state=True)
        y0, h0 = selective_scan(dt, b, c, x, a, return_state=True,
                                use_kernel=False)
        assert n == 1 and torch.equal(y, y0) and torch.equal(h, h0)


FLASH_CASES = [  # B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset
    (2, 100, 100, 8, 2, 128, True, 0, 0),
    (1, 37, 90, 4, 1, 64, True, 0, 53),      # Sq != Sk, decode-tail offset
    (2, 70, 70, 4, 4, 64, True, 16, 0),      # sliding window
    (1, 50, 130, 6, 2, 80, True, 24, 80),    # window + offset, odd dh
    (2, 33, 47, 4, 2, 32, False, 0, 0),      # no mask, ragged tiles
    (4, 1024, 1024, 32, 8, 128, True, 0, 0), # jamba's prefill widths
    (2, 150, 150, 8, 2, 120, True, 0, 0),    # dh 120, off the 64-row tile
    (1, 70, 200, 4, 2, 96, True, 32, 130),   # dh 96, window + offset
    (2, 200, 200, 40, 8, 128, True, 0, 0),   # llama4's heads, G = 5
    (4, 1024, 1024, 32, 8, 160, True, 0, 0), # stablelm: tensor cores
    (4, 1024, 1024, 16, 16, 64, False, 0, 0),  # seamless's encoder
    (2, 65, 64, 16, 16, 64, False, 0, 0),    # its cross-attention, Sq > Sk
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window,q_offset",
                         FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_vs_plain(cuda, B, Sq, Sk, Hq, Hkv, dh, causal,
                                       window, q_offset, dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_launches
    g = torch.Generator(device=cuda).manual_seed(4)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v = rnd(B, Sq, Hq, dh), rnd(B, Sk, Hkv, dh), rnd(B, Sk, Hkv, dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    n0 = flash_attention_launches.n
    got = flash_attention(q, k, v, **kw)
    want = flash_attention(q, k, v, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert flash_attention_launches.n == n0 + 1
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-5
    else:
        assert _bf16_ulp_ratio(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,which", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 80, "wgmma"),
    (torch.float32, 128, "split_f32"), (torch.bfloat16, 160, "wgmma"),
    (torch.bfloat16, 192, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "split_f32"),
    (torch.float32, 160, "split_f32"), (torch.bfloat16, 37, "wgmma"),
    (torch.float32, 37, "split_f32")])
def test_cuda_flash_attention_route_counters(cuda, dtype, dh, which):
    """Each input takes the route ``route`` names and raises that route's
    counter and no other: bf16 up to dh 256 ``wgmma``, f32 up to dh 256
    the split route (three ``split_bf16x3`` passes, then one attention
    launch); at dh 37 (rows of 74 or 148 bytes, which no tensor map takes)
    bf16 packs q, k and v first (three ``pack_bf16`` passes). Every launch
    raises the flash counter once."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as fk
    g = torch.Generator(device=cuda).manual_seed(6)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    q, k, v = rnd(2, 90, 8, dh), rnd(2, 90, 2, dh), rnd(2, 90, 2, dh)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert fk.route(*views) == which
    packs = sum(fk.packed(*views)) if which == "wgmma" else 0
    assert packs == (3 if (dh, which) == (37, "wgmma") else 0)
    n0 = _build.counts()
    got = flash_attention(q, k, v)
    want = flash_attention(q, k, v, use_kernel=False)
    torch.cuda.synchronize()
    n1 = _build.counts()
    moved = {c: n1[c] - n0.get(c, 0) for c in n1 if n1[c] != n0.get(c, 0)}
    assert fk.route_counter(which).name == {
        "wgmma": "flash_attention_wgmma",
        "split_f32": "flash_attention_split_f32"}[which]
    assert moved == {"flash_attention": 1,
                     fk.route_counter(which).name: 1,
                     **({"split_bf16x3": 3} if which == "split_f32"
                        else {}),
                     **({"pack_bf16": packs} if packs else {})}
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-5
    else:
        assert _bf16_ulp_ratio(got, want) <= 1.0


FLASH_160_CASES = [  # B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset
    (2, 200, 200, 8, 2, 160, True, 0, 0),    # Sq off the 64 / 128-row tiles
    (1, 70, 333, 8, 1, 160, True, 0, 263),   # Sq != Sk, decode-tail offset
    (2, 300, 300, 16, 4, 160, True, 100, 0),  # sliding window
    (1, 129, 250, 32, 4, 160, True, 40, 121),  # window + offset, G 8
    (2, 65, 190, 8, 2, 160, False, 0, 0),    # no mask, ragged tiles
    (1, 200, 200, 4, 1, 160, True, 0, -100),  # first 100 rows masked: a
                                              # whole warpgroup of block 0
    (1, 150, 64, 4, 1, 160, True, 16, 60),   # the window masks rows 19+:
                                              # block 0's second warpgroup
    (2, 130, 130, 8, 2, 136, True, 0, 0),    # dh 136 in the 160 tiles
    (1, 256, 256, 8, 2, 144, True, 0, 0),    # dh 144, whole 128-row tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window,q_offset",
                         FLASH_160_CASES)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_cuda_flash_attention_dh160_on_the_tensor_cores(
        cuda, B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset, layout):
    """bf16 with dh in (128, 160] on the tensor-core route (two warpgroups
    a block) within one bf16 ulp of the plain version, in the model's
    strided ``[B, S, H, dh]`` view and in ``[B, H, S, dh]``; fully masked
    rows are 0."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=cuda).manual_seed(8)
    rnd = lambda b, s_, h: torch.randn((b, s_, h, dh), generator=g,
                                       device=cuda).to(torch.bfloat16)
    q, k, v = rnd(B, Sq, Hq), rnd(B, Sk, Hkv), rnd(B, Sk, Hkv)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    else:
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert fk.tensor_core_route(q, k, v) and not any(fk.packed(q, k, v))
    t0 = fk.flash_attention_wgmma_launches.n
    p0 = fk.pack_bf16_launches.n
    got = fk.flash_attention_fwd(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fk.flash_attention_wgmma_launches.n == t0 + 1
    assert fk.pack_bf16_launches.n == p0
    assert got.stride() == q.stride()
    assert _bf16_ulp_ratio(got, want) <= 1.0
    if q_offset < 0:
        assert not got[:, :, :-q_offset].any()


@pytest.mark.cuda
def test_cuda_flash_attention_dh160_resources(cuda):
    """The dh-160 instantiation spills nothing and keeps one block of two
    warpgroups an SM; dh 128's keeps two of one."""
    from repro_torch.kernels.flash_attention import kernel as fk
    wide, narrow = fk.tensor_core_resources(160), fk.tensor_core_resources(
        128)
    assert wide["local_bytes"] == 0 and narrow["local_bytes"] == 0
    assert (wide["threads"], wide["blocks_per_sm"]) == (256, 1)
    assert (narrow["threads"], narrow["blocks_per_sm"]) == (128, 2)
    assert wide["shared_bytes"] == 1024 + 6 * 3 * 8192 + 24


@pytest.mark.cuda
def test_cuda_flash_attention_dh160_launch_failure_raises(cuda,
                                                          monkeypatch):
    """A dh-160 launch whose C entry point returns an error raises: no
    fallback to the plain version, and no counter moves."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    t = torch.ones((1, 4, 70, 160), device=cuda, dtype=torch.bfloat16)
    n0 = dict(_build.counts())
    monkeypatch.setattr(_build, "launch", lambda fn, index, *args: 1)
    with pytest.raises(RuntimeError, match="flash_attention_wgmma_launch"):
        fk.flash_attention_fwd(t, t[:, :2], t[:, :2])
    assert _build.counts() == n0


FLASH_192_256_CASES = [  # B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset
    (2, 200, 200, 8, 2, 192, True, 0, 0),    # DHP 192, Sq off the tiles
    (1, 70, 333, 8, 1, 176, True, 0, 263),   # dh 176 in the 192 tiles,
                                              # decode-tail offset
    (2, 300, 300, 16, 4, 200, True, 100, 0),  # dh 200 in the 256 tiles,
                                              # sliding window
    (1, 129, 250, 32, 4, 256, True, 40, 121),  # window + offset, G 8
    (2, 65, 190, 8, 2, 256, False, 0, 0),    # no mask, ragged tiles
    (1, 200, 200, 4, 1, 192, True, 0, -100),  # first 100 rows masked: a
                                              # whole warpgroup of block 0
    (1, 200, 200, 4, 1, 256, True, 0, -100),  # ... at DHP 256
    (1, 150, 64, 4, 1, 192, True, 16, 60),   # the window masks rows 19+,
                                              # all past Sk: block 0's
                                              # second warpgroup
    (1, 150, 64, 4, 1, 256, True, 16, 60),   # ... at DHP 256
    (2, 512, 512, 16, 4, 192, True, 0, 0),   # the smoke's dh-192 row
    (2, 512, 512, 16, 4, 256, True, 0, 0),   # ... and its dh-256 row
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window,q_offset",
                         FLASH_192_256_CASES)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_cuda_flash_attention_dh192_256_on_the_tensor_cores(
        cuda, B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset, layout):
    """bf16 with dh in (160, 256] on ``wgmma`` (the DHP-192 and DHP-256
    instantiations, two warpgroups a block) within
    one bf16 ulp of the plain version, in the model's strided ``[B, S, H,
    dh]`` view and in ``[B, H, S, dh]``; fully masked rows are 0; nothing
    is packed."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=cuda).manual_seed(9)
    rnd = lambda b, s_, h: torch.randn((b, s_, h, dh), generator=g,
                                       device=cuda).to(torch.bfloat16)
    q, k, v = rnd(B, Sq, Hq), rnd(B, Sk, Hkv), rnd(B, Sk, Hkv)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    else:
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert fk.route(q, k, v) == "wgmma" and not any(fk.packed(q, k, v))
    t0 = fk.flash_attention_wgmma_launches.n
    p0 = fk.pack_bf16_launches.n
    got = fk.flash_attention_fwd(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fk.flash_attention_wgmma_launches.n == t0 + 1
    assert fk.pack_bf16_launches.n == p0
    assert got.stride() == q.stride()
    assert _bf16_ulp_ratio(got, want) <= 1.0
    if q_offset < 0:
        assert not got[:, :, :-q_offset].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dtype,shared,threads", [
    (192, torch.bfloat16, 1024 + 6 * 3 * 8192 + 24, 256),
    (256, torch.bfloat16, 1024 + 6 * 4 * 8192 + 24, 256),
    (128, torch.float32, 1024 + 2 * 3 * 2 * 8192 + 4 * 3 * 2 * 4096 + 24,
     256),
    (64, torch.float32, 1024 + 3 * 8192 + 4 * 3 * 4096 + 24, 128)])
def test_cuda_flash_attention_wide_and_split_resources(cuda, dh, dtype,
                                                       shared, threads):
    """The DHP-192 / 256 bf16 instantiations and the split route's spill
    nothing, with the shared bytes of their layouts: two Q tiles and two
    stages of K and V, 64-key tiles of 64-column boxes (bf16), or three
    parts of each, K/V tiles of 32 keys (f32); the two-warpgroup blocks
    one an SM, the split route's DHP 64 (one warpgroup) at least two."""
    from repro_torch.kernels.flash_attention import kernel as fk
    res = fk.tensor_core_resources(dh, dtype)
    assert res["local_bytes"] == 0
    assert res["shared_bytes"] == shared and res["threads"] == threads
    if threads == 256:
        assert res["blocks_per_sm"] == 1
    else:
        assert res["blocks_per_sm"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", [
    ((4, 32, 1024, 128), "bhsd"), ((2, 5, 77, 64), "bshd"),
    ((1, 3, 33, 37), "bhsd"), ((2, 4, 19, 120), "bshd")])
def test_cuda_split_bf16x3_bitwise(cuda, shape, layout):
    """The split pass bitwise equal to ``split_bf16x3_ref`` (bf16 bits
    compared as int16), on contiguous ``[B, H, S, dh]`` and the model's
    strided view, dh off a multiple of 8 (37: rows padded to 40); the
    parts sum back to x."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import split_bf16x3_ref
    g = torch.Generator(device=cuda).manual_seed(10)
    B, H, S, dh = shape
    x = torch.randn((B, S, H, dh) if layout == "bshd" else shape,
                    generator=g, device=cuda) * 3
    if layout == "bshd":
        x = x.transpose(1, 2)
    n0 = fk.split_bf16x3_launches.n
    got = fk.split_bf16x3(x)
    want = split_bf16x3_ref(x)
    torch.cuda.synchronize()
    assert fk.split_bf16x3_launches.n == n0 + 1
    assert got.shape == want.shape == (3,) + shape
    assert got.data_ptr() % 16 == 0 and got.stride(3) % 8 == 0
    assert torch.equal(got.contiguous().view(torch.int16),
                       want.contiguous().view(torch.int16))
    hi, mid, lo = got.float()
    assert torch.equal((hi + mid) + lo, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [192, 256])
def test_cuda_flash_attention_dh192_256_launch_failure_raises(cuda, dh,
                                                              monkeypatch):
    """A dh-192 / 256 launch whose C entry point returns an error raises:
    no fallback to the plain version, and no counter moves."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    t = torch.ones((1, 4, 70, dh), device=cuda, dtype=torch.bfloat16)
    n0 = dict(_build.counts())
    monkeypatch.setattr(_build, "launch", lambda fn, index, *args: 1)
    with pytest.raises(RuntimeError, match="flash_attention_wgmma_launch"):
        fk.flash_attention_fwd(t, t[:, :2], t[:, :2])
    assert _build.counts() == n0


@pytest.mark.cuda
@pytest.mark.parametrize("failing", ["split_bf16x3_launch",
                                     "flash_attention_split_f32_launch"])
def test_cuda_flash_attention_split_launch_failure_raises(cuda, failing,
                                                          monkeypatch):
    """On the split route a failed split pass or a failed attention launch
    raises, naming its entry point: no fallback to the plain version. No
    flash counter moves; the split counter counts only the passes that
    launched (none, or all three)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    t = torch.ones((1, 4, 70, 128), device=cuda)
    n0 = dict(_build.counts())
    real = _build.launch
    monkeypatch.setattr(_build, "launch", lambda fn, index, *args: 1 if
                        fn.__name__ == failing else real(fn, index, *args))
    with pytest.raises(RuntimeError, match=failing):
        fk.flash_attention_fwd(t, t[:, :2], t[:, :2])
    torch.cuda.synchronize()
    n1 = _build.counts()
    split = 3 if failing == "flash_attention_split_f32_launch" else 0
    assert n1 == dict(n0, split_bf16x3=n0.get("split_bf16x3", 0) + split)


def _strided(x, pad, offset):
    """x [B, H, S, dh] as a view into a buffer whose rows are ``dh + pad``
    elements wide and whose base is ``offset`` elements in; the same
    values."""
    B, H, S, dh = x.shape
    buf = torch.zeros(offset + B * H * S * (dh + pad), dtype=x.dtype,
                      device=x.device)
    view = buf[offset:].view(B, H, S, dh + pad)[..., :dh]
    view.copy_(x)
    return view


FLASH_PACKED_CASES = [  # B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset
    (2, 100, 100, 8, 2, 64, True, 0, 0),
    (1, 70, 200, 4, 2, 128, True, 32, 130),   # window + offset
    (2, 200, 200, 8, 2, 160, True, 0, 0),     # stablelm's width
    (1, 150, 64, 4, 1, 192, True, 16, 60),    # a window past Sk
    (2, 65, 190, 8, 2, 256, False, 0, 0),     # no mask, ragged tiles
    (1, 200, 200, 4, 1, 192, True, 0, -100),  # a fully masked warpgroup
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window,q_offset",
                         FLASH_PACKED_CASES)
@pytest.mark.parametrize("which,pad,offset", [
    ("qkv", 3, 0), ("qkv", 0, 1), ("k", 5, 0)])
def test_cuda_flash_attention_bf16_packed_views(
        cuda, B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset, which, pad,
        offset):
    """bf16 on views no tensor map takes (rows padded by an odd count of
    elements, or a base 2 bytes off; all three operands, or k alone):
    packed first, one ``pack_bf16`` a view, then ``wgmma``, within one
    bf16 ulp of the plain version; the output keeps q's layout."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=cuda).manual_seed(12)
    rnd = lambda h, n: torch.randn((B, h, n, dh), generator=g,
                                   device=cuda).to(torch.bfloat16)
    q, k, v = rnd(Hq, Sq), rnd(Hkv, Sk), rnd(Hkv, Sk)
    q, k, v = (_strided(t, pad, offset) if n in which else t
               for t, n in zip((q, k, v), "qkv"))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want_packed = tuple(n in which for n in "qkv")
    assert fk.route(q, k, v) == "wgmma"
    assert fk.packed(q, k, v) == want_packed
    n0 = _build.counts()
    got = fk.flash_attention_fwd(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    n1 = _build.counts()
    moved = {c: n1[c] - n0.get(c, 0) for c in n1 if n1[c] != n0.get(c, 0)}
    assert moved == {"flash_attention": 1, "flash_attention_wgmma": 1,
                     "pack_bf16": sum(want_packed)}
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _bf16_ulp_ratio(got, want) <= 1.0
    if q_offset < 0:
        assert not got[:, :, :-q_offset].any()


FLASH_F32_WIDE_CASES = [  # B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset
    (2, 130, 130, 8, 2, 136, True, 0, 0),     # dh 136 in the 192 tiles
    (2, 200, 200, 8, 2, 160, True, 0, 0),     # stablelm's width
    (1, 70, 333, 8, 1, 160, True, 0, 263),    # decode-tail offset
    (2, 300, 300, 16, 4, 192, True, 100, 0),  # sliding window
    (1, 129, 250, 32, 4, 200, True, 40, 121),  # dh 200 in the 256 tiles
    (2, 65, 190, 8, 2, 256, False, 0, 0),     # no mask, ragged tiles
    (1, 200, 200, 4, 1, 160, True, 0, -100),  # a fully masked query tile
    (1, 200, 200, 4, 1, 256, True, 0, -100),  # ... at DHP 256
    (1, 150, 64, 4, 1, 192, True, 16, 60),    # a window past Sk
    (1, 150, 64, 4, 1, 256, True, 16, 60),    # ... at DHP 256
    (4, 1024, 1024, 32, 8, 160, True, 0, 0),  # stablelm's prefill (6'cc)
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,causal,window,q_offset",
                         FLASH_F32_WIDE_CASES)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_cuda_flash_attention_f32_wide_on_the_split_route(
        cuda, B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset, layout):
    """f32 with dh in (128, 256] on the split route (DHP 192: 32-key
    tiles; DHP 256: 16-key tiles; one warpgroup a block) within
    2e-5 of the plain version, in the model's strided ``[B, S, H, dh]``
    view and in ``[B, H, S, dh]``; fully masked rows are 0."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=cuda).manual_seed(13)
    rnd = lambda b, s_, h: torch.randn((b, s_, h, dh), generator=g,
                                       device=cuda)
    q, k, v = rnd(B, Sq, Hq), rnd(B, Sk, Hkv), rnd(B, Sk, Hkv)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    else:
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert fk.route(q, k, v) == "split_f32"
    n0 = _build.counts()
    got = fk.flash_attention_fwd(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    n1 = _build.counts()
    moved = {c: n1[c] - n0.get(c, 0) for c in n1 if n1[c] != n0.get(c, 0)}
    assert moved == {"flash_attention": 1, "flash_attention_split_f32": 1,
                     "split_bf16x3": 3}
    assert got.stride() == q.stride()
    assert (got - want).abs().max().item() <= 2e-5
    if q_offset < 0:
        assert not got[:, :, :-q_offset].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dh,pad,offset,q_offset", [
    (64, 2, 0, 0), (128, 0, 2, 0), (128, 6, 1, -70), (96, 1, 3, 30)])
def test_cuda_flash_attention_f32_views_no_tensor_map_takes(
        cuda, dh, pad, offset, q_offset):
    """f32 at dh <= 128 on views no tensor map takes (rows padded off whole
    16-byte units, a base off a 16-byte boundary) on the split route,
    whose pass reads any strides: within 2e-5 of the plain version."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=cuda).manual_seed(14)
    rnd = lambda h, n: torch.randn((2, h, n, dh), generator=g, device=cuda)
    q, k, v = (_strided(t, pad, offset) for t in
               (rnd(8, 150), rnd(2, 180), rnd(2, 180)))
    assert all(fk.packed(q, k, v)) and fk.route(q, k, v) == "split_f32"
    kw = dict(causal=True, window=0, q_offset=q_offset)
    n0 = fk.split_bf16x3_launches.n
    got = fk.flash_attention_fwd(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fk.split_bf16x3_launches.n == n0 + 3
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pad,offset", [
    ((2, 16, 512, 192), 4, 0), ((2, 5, 77, 37), 0, 1),
    ((1, 3, 33, 161), 3, 5), ((2, 4, 19, 256), 0, 0)])
def test_cuda_pack_bf16_bitwise(cuda, shape, pad, offset):
    """The pack bitwise equal to ``pack_bf16_ref`` (bf16 bits compared as
    int16, the zero columns past dh included) on views padded off whole
    16-byte units, a base off a 16-byte boundary, and a contiguous
    tensor."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import pack_bf16_ref
    g = torch.Generator(device=cuda).manual_seed(15)
    x = _strided(torch.randn(shape, generator=g, device=cuda).to(
        torch.bfloat16), pad, offset)
    n0 = fk.pack_bf16_launches.n
    got = fk.pack_bf16(x)
    want = pack_bf16_ref(x)
    torch.cuda.synchronize()
    assert fk.pack_bf16_launches.n == n0 + 1
    assert got.shape == x.shape and got.data_ptr() % 16 == 0
    assert got.stride(2) == want.shape[3] and got.stride(2) % 8 == 0
    whole = torch.as_strided(got, want.shape, want.stride())
    assert torch.equal(whole.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dh,shared,threads", [
    (192, 1024 + 3 * 3 * 8192 + 4 * 3 * 3 * 4096 + 24, 128),
    (256, 1024 + 3 * 4 * 8192 + 4 * 3 * 4 * 2048 + 24, 128)])
def test_cuda_flash_attention_split_wide_resources(cuda, dh, shared,
                                                   threads):
    """The split route's DHP-192 (32-key tiles) and DHP-256 (16-key tiles)
    instantiations, one warpgroup a block, spill nothing, with the shared
    bytes of their layouts (three Q parts, two stages of three K and three
    V parts), one block an SM."""
    from repro_torch.kernels.flash_attention import kernel as fk
    res = fk.tensor_core_resources(dh, torch.float32)
    assert res["local_bytes"] == 0
    assert res["shared_bytes"] == shared and res["threads"] == threads
    assert res["blocks_per_sm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,failing", [
    (torch.bfloat16, 160, "pack_bf16_launch"),
    (torch.bfloat16, 160, "flash_attention_wgmma_launch"),
    (torch.float32, 192, "split_bf16x3_launch"),
    (torch.float32, 256, "flash_attention_split_f32_launch")])
def test_cuda_flash_attention_new_paths_launch_failure_raises(
        cuda, dtype, dh, failing, monkeypatch):
    """A failed pack, a failed attention launch on packed views, and a
    failed split or attention launch at DHP 192 / 256 raise, naming their
    entry point: no fallback to the plain version. No flash counter moves;
    the pack and split counters count only the passes that launched."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    t = torch.ones((1, 4, 70, dh), device=cuda, dtype=dtype)
    if dtype == torch.bfloat16:
        t = _strided(t, 3, 0)
    n0 = dict(_build.counts())
    real = _build.launch
    monkeypatch.setattr(_build, "launch", lambda fn, index, *args: 1 if
                        fn.__name__ == failing else real(fn, index, *args))
    with pytest.raises(RuntimeError, match=failing):
        fk.flash_attention_fwd(t, t[:, :2], t[:, :2])
    torch.cuda.synchronize()
    passes = "pack_bf16" if dtype == torch.bfloat16 else "split_bf16x3"
    n = 3 if failing.startswith("flash_attention") else 0
    assert _build.counts() == dict(n0, **{passes: n0.get(passes, 0) + n})


@pytest.mark.cuda
def test_cuda_build_failure_raises_and_never_falls_back(cuda, monkeypatch,
                                                        tmp_path):
    """A kernel whose source does not compile raises from the wrapper; the
    plain version is not taken in its place."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.kernels.selective_scan.kernel import \
        selective_scan_launches
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "selective_scan.cu").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    t = torch.ones((1, 3, 4), device=cuda)
    n0 = selective_scan_launches.n
    with pytest.raises(RuntimeError, match="nvcc failed"):
        selective_scan(t, torch.ones((1, 3, 8), device=cuda),
                       torch.ones((1, 3, 8), device=cuda), t,
                       -torch.ones((4, 8), device=cuda))
    assert selective_scan_launches.n == n0


@pytest.mark.cuda
def test_cuda_one_jamba_block_prefill_matches_decode(cuda, monkeypatch):
    """One Jamba block of jamba-v0.1 at a quarter of its width, f32 with
    TF32 off: prefill of S + 3 tokens (flash + scan kernels) against
    prefill of S then 3 decode steps (the plain decode recurrence and
    decode attention), at the model tolerance 5e-3."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build_model
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(configs.get_config("jamba_v01_52b"),
                              n_layers=8, d_model=1024, d_ff=2048,
                              vocab_size=4096, dtype="float32")
    model = build_model(cfg, device=cuda, seed=0)
    g = torch.Generator(device=cuda).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 67), generator=g,
                         device=cuda)
    full, _ = model.prefill(toks, 70)
    logits, st = model.prefill(toks[:, :64], 70)
    for t in range(64, 67):
        logits, st = model.decode_step(toks[:, t], st)
    torch.cuda.synchronize()
    assert torch.isfinite(full).all()
    assert ((logits - full).abs() <= 5e-3 + 5e-3 * full.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("async_dp,placement,budget", [
    (False, "block", None), (True, "interleave", 2)])
def test_cuda_four_shard_sweep_equals_the_cpu_sweep(cuda, async_dp,
                                                    placement, budget):
    """A sweep of the cold pool over four home shards: on the card (the
    gather kernels move the bytes) and on the CPU (their plain version)
    the same integers and the same hot bytes, three sweeps with a write
    between them; then the hot-tier attention equals the flat pool's
    bitwise on the card."""
    from repro_torch.kernels import _build
    from repro_torch.paging import tiered_kv as tt
    from repro_torch.paging.kv_cache import paged_decode_attention
    from repro_torch.paging.sharded_pool import ShardedPoolCfg

    S, npps, ps, hkv, dh = 4, 12, 16, 2, 64
    n_pages = S * npps
    geom = tt.TieredKV(n_pages, tt.tiered_min_slots(
        npps, tt.TieredKV(n_pages, 1, ps, hkv, dh)), ps, hkv, dh)
    fabric = ShardedPoolCfg(n_shards=4, placement=placement,
                            link_budget=budget, far_delay=3)
    g = torch.Generator().manual_seed(3)
    cold = {k: torch.randn((n_pages, ps, hkv, dh), generator=g).to(
        torch.bfloat16) for k in ("k", "v")}
    rows = (torch.arange(S)[:, None] * npps
            + (torch.arange(npps)[None] * 5) % npps).to(torch.int32)
    rows[2, 9:] = -1
    states = {d: tt.tiered_init(geom, S, torch.bfloat16, d)
              for d in ("cpu", "cuda")}
    colds = {"cpu": cold, "cuda": {k: v.to(cuda) for k, v in cold.items()}}
    name = "gather_pages_async" if async_dp else "gather_pages"
    n0 = _build.counts().get(name, 0)
    for sweep in range(3):
        if sweep:                       # a write between sweeps
            inv = rows[:, sweep:sweep + 1]
            for d in states:
                colds[d]["k"][inv[:, 0].clamp(min=0).long()] += 1
                states[d] = tt.tiered_invalidate(states[d], inv.to(d))
        infos = {}
        for d in states:
            states[d], infos[d] = tt.tiered_sweep(
                states[d], colds[d], rows.to(d), geom,
                async_datapath=async_dp, fabric=fabric)
        for k in infos["cpu"]:
            assert torch.equal(infos["cpu"][k], infos["cuda"][k].cpu()), k
        for group in ("leap", "pool_meta", "ring", "hot"):
            for k, v in states["cpu"][group].items():
                assert torch.equal(v, states["cuda"][group][k].cpu()), \
                    (sweep, group, k)
    assert _build.counts()[name] > n0
    lengths = torch.tensor([180, 100, 144, 7], dtype=torch.int32,
                           device=cuda)
    q = torch.randn((S, 1, 8, dh), generator=g).to(torch.bfloat16).to(cuda)
    out, ok = tt.tiered_attention(q, states["cuda"], rows.to(cuda), lengths,
                                  attn_kernel="fused")
    flat = paged_decode_attention(
        q, {k: v[None] for k, v in colds["cuda"].items()}, 0, rows.to(cuda),
        lengths, use_kernel=True)
    assert bool(ok) and torch.equal(out, flat)


@pytest.mark.cuda
def test_cuda_consume_with_migration_equals_the_cpu(cuda):
    """The consume scan with the §12 lifecycle and its compressed tier
    (four shards, block, link budget 2): on the card and on the CPU the
    same integers, ``info``, tier tables and hot bytes."""
    from repro_torch.paging import prefetch_serving as tps
    from repro_torch.paging import sharded_pool as tsp
    from repro_torch.paging.lifecycle import MigrationCfg

    n_pages, T = 64, 48
    t = torch.arange(T)
    sched = torch.stack([(16 + 2 * t) % n_pages,
                         (40 + 3 * t) % n_pages]).to(torch.int32)
    g = torch.Generator().manual_seed(5)
    cold = {k: torch.randn((n_pages, 16, 2, 8), generator=g).to(
        torch.bfloat16) for k in ("k", "v")}
    geom = tps.PrefetchedStream(n_pages=n_pages, n_slots=n_pages,
                                page_elems=16 * 2 * 8, ring_size=8, pw_max=4)
    fabric = tsp.ShardedPoolCfg(n_shards=4, placement="block",
                                link_budget=2, near_delay=1, far_delay=3)
    mig = MigrationCfg(mig_per_stream=2, lead=1, cooldown=8, compressed=True,
                       far_capacity=n_pages // 2, demote_per_step=2)
    out = {d: tsp.sharded_multi_stream_consume(
        {k: v.to(d) for k, v in cold.items()}, sched.to(d), geom, fabric,
        migration=mig) for d in ("cpu", "cuda")}
    (cst, csums, cinfo), (gst, gsums, ginfo) = out["cpu"], out["cuda"]
    assert torch.equal(csums, gsums.cpu())
    assert set(cinfo) == set(ginfo)
    for k in cinfo:
        assert torch.equal(cinfo[k], ginfo[k].cpu()), k
    for group in ("leap", "pool_meta", "ring", "hot", "tier"):
        for k, v in cst[group].items():
            assert torch.equal(v, gst[group][k].cpu()), (group, k)
    assert int(cinfo["migrated"].sum()) > 0
    assert int(cinfo["demoted"].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("async_dp", [False, True])
def test_cuda_lifecycle_sweep_equals_the_cpu_sweep(cuda, async_dp):
    """``tiered_sweep`` with ``home_map`` / ``comp_map`` over four shards,
    three sweeps with a demotion (the page codec on the cold bytes, then an
    invalidation) between them: the card (sync: ``gather_pages`` and the
    hot-slot kernel; async: their async twins) and the CPU give the same
    integers and hot bytes; the hot-tier attention equals the flat pool's
    bitwise on the card."""
    from repro_torch.kernels import _build
    from repro_torch.paging import tiered_kv as tt
    from repro_torch.paging.kv_cache import paged_decode_attention
    from repro_torch.paging.sharded_pool import ShardedPoolCfg
    from repro_torch.runtime.compression import roundtrip_pages

    S, npps, ps, hkv, dh = 4, 12, 16, 2, 64
    n_pages = S * npps
    geom = tt.TieredKV(n_pages, tt.tiered_min_slots(
        npps, tt.TieredKV(n_pages, 1, ps, hkv, dh)), ps, hkv, dh)
    fabric = ShardedPoolCfg(n_shards=4, placement="interleave",
                            link_budget=2, far_delay=3)
    g = torch.Generator().manual_seed(4)
    cold = {k: torch.randn((n_pages, ps, hkv, dh), generator=g).to(
        torch.bfloat16) for k in ("k", "v")}
    rows = (torch.arange(S)[:, None] * npps
            + (torch.arange(npps)[None] * 5) % npps).to(torch.int32)
    rows[2, 9:] = -1
    home = torch.randint(0, 4, (n_pages,), generator=g, dtype=torch.int32)
    comp = torch.rand((n_pages,), generator=g) < 0.5
    states = {d: tt.tiered_init(geom, S, torch.bfloat16, d)
              for d in ("cpu", "cuda")}
    colds = {"cpu": cold, "cuda": {k: v.to(cuda) for k, v in cold.items()}}
    gather = "gather_pages_async" if async_dp else "gather_pages"
    n0 = _build.counts().get(gather, 0)
    for sweep in range(3):
        if sweep:                       # demote two pages between sweeps
            vict = rows[sweep, 2 * sweep:2 * sweep + 2].long()
            comp[vict] = True
            for d in states:
                for k in ("k", "v"):
                    colds[d][k][vict.to(d)] = roundtrip_pages(
                        colds[d][k][vict.to(d)])
                states[d] = tt.tiered_invalidate(
                    states[d], vict.to(torch.int32)[None].expand(S, 2).to(d))
        infos = {}
        for d in states:
            states[d], infos[d] = tt.tiered_sweep(
                states[d], colds[d], rows.to(d), geom,
                async_datapath=async_dp, fabric=fabric,
                home_map=home.to(d), comp_map=comp.to(d),
                decompress_delay=2)
        for k in infos["cpu"]:
            assert torch.equal(infos["cpu"][k], infos["cuda"][k].cpu()), k
        for group in ("leap", "pool_meta", "ring", "hot"):
            for k, v in states["cpu"][group].items():
                assert torch.equal(v, states["cuda"][group][k].cpu()), \
                    (sweep, group, k)
    for k in ("k", "v"):
        assert torch.equal(colds["cpu"][k], colds["cuda"][k].cpu())
    assert _build.counts()[gather] > n0
    lengths = torch.tensor([180, 100, 144, 7], dtype=torch.int32,
                           device=cuda)
    q = torch.randn((S, 1, 8, dh), generator=g).to(torch.bfloat16).to(cuda)
    mode = "fused_async" if async_dp else "fused"
    name = ("paged_attention_hot_slots_async" if async_dp
            else "paged_attention_hot_slots")
    a0 = _build.counts().get(name, 0)
    out, ok = tt.tiered_attention(q, states["cuda"], rows.to(cuda), lengths,
                                  attn_kernel=mode)
    flat = paged_decode_attention(
        q, {k: v[None] for k, v in colds["cuda"].items()}, 0, rows.to(cuda),
        lengths, use_kernel=True)
    assert bool(ok) and torch.equal(out, flat)
    assert _build.counts()[name] == a0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_page_codec_equals_the_cpu(cuda, dtype):
    """The page codec on the card: bitwise the CPU's, page by page and
    batched, at the serve's page shape and at magnitudes from 1e-3 to
    1e3."""
    from repro_torch.runtime import compression as codec

    g = torch.Generator().manual_seed(6)
    pages = (torch.randn((64, 16, 2, 128), generator=g)
             * torch.logspace(-3, 3, 64)[:, None, None, None]).to(dtype)
    pages[3] = 0
    want = codec.roundtrip_pages(pages)
    got = codec.roundtrip_pages(pages.to(cuda))
    assert torch.equal(want, got.cpu())
    for i in (0, 3, 17, 63):
        assert torch.equal(codec.page_roundtrip(pages[i].to(cuda)).cpu(),
                           want[i])
        q, s = codec.compress_page(pages[i].to(cuda))
        wq, ws = codec.compress_page(pages[i])
        assert torch.equal(q.cpu(), wq) and torch.equal(s.cpu(), ws)


# --------------------------------------------------------------------------
# the training side on the card
# --------------------------------------------------------------------------
@pytest.mark.cuda
def test_cuda_forward_only_kernels_refuse_grad_inputs(cuda):
    """flash_attention and selective_scan raise on CUDA inputs that require
    grad under grad mode, naming the train route; under no_grad the same
    inputs launch the kernels."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = [torch.randn((1, 64, 2, 64), generator=g, device=cuda,
                       dtype=torch.bfloat16) for _ in range(3)]
    ss = [torch.rand((1, 32, 64), generator=g, device=cuda),
          torch.randn((1, 32, 16), generator=g, device=cuda),
          torch.randn((1, 32, 16), generator=g, device=cuda),
          torch.randn((1, 32, 64), generator=g, device=cuda),
          -torch.rand((64, 16), generator=g, device=cuda)]
    for fn, args, route in ((flash_attention, qkv, "train_attention"),
                            (selective_scan, ss, "apply_mamba_train")):
        want = fn(*args)
        for i in range(len(args)):
            a = list(args)
            a[i] = a[i].clone().requires_grad_(True)
            with pytest.raises(RuntimeError, match=route):
                fn(*a)
            with torch.no_grad():
                assert torch.equal(fn(*a), want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "jamba_v01_52b"])
def test_cuda_smoke_train_step_matches_the_cpu(cuda, arch, monkeypatch):
    """One train step of the smoke config, f32 with TF32 off, on the card
    and on the CPU from the same weights and batch: the loss within 1e-5
    relative and every gradient within 1e-4 of its largest magnitude; then
    AdamW from the same gradients on both, parameters and moments within
    1e-6 of their largest magnitudes. (Adam's first step divides each
    gradient by its own magnitude, so an update from each device's own
    gradients turns their rounding into a sign's worth on elements near
    eps: the update is held from equal gradients.)"""
    from repro_torch import configs
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, param_tree
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.get_smoke_config(arch)
    cpu = build_model(cfg, device="cpu", seed=0, trainable=True)
    card = build_model(cfg, device=cuda, seed=None, trainable=True)
    card.load_state_dict(cpu.state_dict())
    batch = make_pipeline(cfg.vocab_size, 2, 16, seed=1).peek(0)
    losses = []
    for model in (cpu, card):
        loss = model.train_forward({k: torch.from_numpy(v).to(model.device)
                                    for k, v in batch.items()})
        loss.backward()
        losses.append(float(loss.detach()))
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    pairs = list(zip(cpu.parameters(), card.parameters()))
    for p, q in pairs:
        err = float((q.grad.cpu() - p.grad).abs().max())
        assert err <= 1e-4 * float(p.grad.abs().max())
        q.grad.copy_(p.grad)
    init, update = make_optimizer("adamw", 1e-2)
    states = []
    for model in (cpu, card):
        tree = param_tree(model)
        state = init(tree)
        update({k: [p.grad for p in parts] for k, parts in tree.items()},
               state, tree, 0)
        states.append(state)
    for p, q in pairs:
        err = float((q.detach().cpu() - p.detach()).abs().max())
        assert err <= 1e-6 * float(p.detach().abs().max())
    for key in ("m", "v"):
        for k, parts in states[0][key].items():
            for a, b in zip(parts, states[1][key][k]):
                err = float((b.cpu() - a).abs().max())
                assert err <= 1e-6 * float(a.abs().max()), (key, k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "jamba_v01_52b"])
def test_cuda_trainer_kill_and_restart_is_bitwise(cuda, arch, tmp_path,
                                                  monkeypatch):
    """The trainer CLI on the card (deterministic algorithms on): a
    failure at step 6, a restore of the step-4 checkpoint, and the losses
    bit for bit those of an uninterrupted run. The deterministic
    algorithms ask for the cuBLAS workspace setting, which the trainer's
    entry point sets; here the test does."""
    from repro_torch.launch import train
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    args = ["--arch", arch, "--smoke", "--steps", "12", "--global-batch",
            "4", "--seq-len", "16", "--log-every", "100"]
    clean = train.main(args)["history"]
    fail, make = {6: True}, train.make_pipeline

    def failing(*a, **kw):
        pipe = make(*a, **kw)
        peek = pipe.peek

        def once(step):
            if fail.pop(step, False):
                raise RuntimeError("injected failure")
            return peek(step)

        pipe.peek = once
        return pipe

    monkeypatch.setattr(train, "make_pipeline", failing)
    got = train.main(args + ["--ckpt-dir", str(tmp_path), "--save-every",
                             "4"])["history"]
    assert not fail and got == clean[:6] + clean[4:]
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm_350m", "seamless_m4t_medium"])
def test_cuda_recurrent_and_encdec_train_grads_match_the_cpu(cuda, arch,
                                                            monkeypatch):
    """The xLSTM and encoder-decoder train routes on the card against the
    CPU, f32 with TF32 off, smoke configs at 2 x 256 tokens (two chunks
    of the recurrences; seeded frames for the encoder-decoder): the loss
    within 1e-5 relative, every gradient within 1e-4 of its largest
    magnitude."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.get_smoke_config(arch)
    cpu = build_model(cfg, device="cpu", seed=0, trainable=True)
    card = build_model(cfg, device=cuda, seed=None, trainable=True)
    card.load_state_dict(cpu.state_dict())
    batch = dict(make_pipeline(cfg.vocab_size, 2, 256, seed=1).peek(0))
    if cfg.family == "encdec":
        batch["frames"] = np.random.default_rng(1).standard_normal(
            (2, 256, cfg.d_model)).astype(np.float32)
    losses = []
    for model in (cpu, card):
        loss = model.train_forward({k: torch.from_numpy(v).to(model.device)
                                    for k, v in batch.items()})
        loss.backward()
        losses.append(float(loss.detach()))
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        err = float((q.grad.cpu() - p.grad).abs().max())
        assert err <= 1e-4 * float(p.grad.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gradient_codec_equals_the_cpu(cuda, dtype):
    """compress_int8 / decompress_int8 on the card: q, the scale and the
    new error bitwise the CPU's, at magnitudes from 1e-3 to 1e3."""
    from repro_torch.runtime import compression as codec
    g = torch.Generator().manual_seed(7)
    for scale in (1e-3, 1.0, 1e3):
        grad = (torch.randn((257, 129), generator=g) * scale).to(dtype)
        err = torch.randn((257, 129), generator=g) * scale * 1e-3
        want = codec.compress_int8(grad, err)
        got = codec.compress_int8(grad.to(cuda), err.to(cuda))
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and torch.equal(a, b.cpu())
        assert torch.equal(codec.decompress_int8(*got[:2]).cpu(),
                           codec.decompress_int8(*want[:2]))


@pytest.mark.cuda
def test_cuda_one_rank_nccl_sharded_step_matches_the_unsharded(cuda,
                                                               tmp_path):
    """A one-rank NCCL group from a file store, ``make_host_mesh()`` on
    the card ((1, 1)): one ``make_sharded_train_step`` of qwen2.5-3b's
    smoke config against ``make_train_step`` on the same state and batch
    (the loss within 1e-5 relative, every updated parameter within 1e-4
    of its largest magnitude); ``compressed_psum`` over the group: the
    new errors bitwise the CPU's ``compress_int8``, the mean ``q *
    scale``."""
    import datetime

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import make_pipeline
    from repro_torch.distributed.sharding import rules_for
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (make_sharded_train_step,
                                          make_train_step)
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer, param_tree
    from repro_torch.runtime import compression as codec

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh()
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
        cfg = configs.get_smoke_config("qwen2_5_3b")
        batch = {k: torch.from_numpy(v).to(cuda) for k, v in
                 make_pipeline(cfg.vocab_size, 4, 16, seed=1).peek(0).items()}
        models, losses = [], []
        for sharded in (False, True):
            model = build_model(cfg, device=cuda, seed=0, trainable=True)
            init, update = make_optimizer("adamw", 1e-4)
            state = init(param_tree(model))
            fn = (make_sharded_train_step(model, update, mesh,
                                          rules_for("train", False))
                  if sharded else make_train_step(model, update))
            losses.append(float(fn(state, batch, 0)[0]))
            models.append(model)
        assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])
        for p, q in zip(models[0].parameters(), models[1].parameters()):
            q = q.detach().full_tensor()
            err = float((q - p.detach()).abs().max())
            assert err <= 1e-4 * float(p.detach().abs().max())
        grads = {"a": torch.randn((64, 33), device=cuda),
                 "b": [torch.randn((300,), device=cuda)]}
        errs = codec.init_error_feedback(grads)
        mean, new_err = codec.compressed_psum(grads, errs)
        for g, m, e in ((grads["a"], mean["a"], new_err["a"]),
                        (grads["b"][0], mean["b"][0], new_err["b"][0])):
            q, sc, want_e = codec.compress_int8(g.cpu(),
                                                torch.zeros(g.shape))
            assert torch.equal(e.cpu(), want_e)
            assert torch.equal(m.cpu(), codec.decompress_int8(q, sc))
    finally:
        dist.destroy_process_group()


# B, Sq, Sk, Hq, Hkv, dh, causal, window, q_offset, dtype, view, cap: every
# route of the capped kernel (bf16 on wgmma at dh 128, 160 and 256; bf16 on
# a view no tensor map takes, packed first; f32 on the split route at dh 128
# and 256), causal, windowed and bidirectional
FLASH_SOFTCAP_CASES = [
    (2, 200, 200, 8, 2, 128, True, 0, 0, torch.bfloat16, "bshd", 2.0),
    (1, 70, 333, 8, 1, 128, True, 64, 263, torch.bfloat16, "bhsd", 1.0),
    (2, 200, 200, 8, 2, 160, True, 0, 0, torch.bfloat16, "bshd", 2.0),
    (2, 65, 190, 8, 2, 160, False, 0, 0, torch.bfloat16, "bhsd", 3.0),
    (2, 300, 300, 16, 4, 256, True, 100, 0, torch.bfloat16, "bshd", 2.0),
    (1, 200, 200, 4, 1, 256, True, 0, -100, torch.bfloat16, "bhsd", 1.5),
    (2, 100, 100, 8, 2, 64, True, 0, 0, torch.bfloat16, "packed", 2.0),
    (1, 150, 64, 4, 1, 192, True, 16, 60, torch.bfloat16, "packed", 1.0),
    (2, 200, 200, 8, 2, 128, True, 0, 0, torch.float32, "bshd", 2.0),
    (2, 65, 190, 8, 2, 128, False, 0, 0, torch.float32, "bhsd", 3.0),
    (2, 300, 300, 16, 4, 256, True, 100, 0, torch.float32, "bshd", 2.0),
    (1, 129, 250, 32, 4, 256, True, 40, 121, torch.float32, "bhsd", 1.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,Sq,Sk,Hq,Hkv,dh,causal,window,q_offset,dtype,view,cap",
    FLASH_SOFTCAP_CASES)
def test_cuda_flash_attention_softcap_vs_plain(cuda, B, Sq, Sk, Hq, Hkv, dh,
                                               causal, window, q_offset,
                                               dtype, view, cap):
    """The soft-capped kernel on every route against
    ``flash_attention_ref(softcap=)``: bf16 within one bf16 ulp (+1e-6),
    f32 within 2e-5. The launch moves the cap's counter beside its
    route's (and the packs or splits the route runs), and the capped
    output differs from the cap-free one by far more than the limit."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    g = torch.Generator(device=cuda).manual_seed(17)
    rnd = lambda h, n: torch.randn((B, n, h, dh), generator=g,
                                   device=cuda).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in (rnd(Hq, Sq), rnd(Hkv, Sk),
                                           rnd(Hkv, Sk)))
    if view == "bhsd":
        q, k, v = (t.contiguous() for t in (q, k, v))
    elif view == "packed":
        q, k, v = (_strided(t.contiguous(), 3, 0) for t in (q, k, v))
    which = fk.route(q, k, v)
    assert which == ("wgmma" if dtype == torch.bfloat16 else "split_f32")
    packs = sum(fk.packed(q, k, v)) if which == "wgmma" else 0
    assert packs == (3 if view == "packed" else 0)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    n0 = _build.counts()
    got = fk.flash_attention_fwd(q, k, v, softcap=cap, **kw)
    torch.cuda.synchronize()
    n1 = _build.counts()
    moved = {c: n1[c] - n0.get(c, 0) for c in n1 if n1[c] != n0.get(c, 0)}
    assert moved == {"flash_attention": 1, "flash_attention_softcap": 1,
                     fk.route_counter(which).name: 1,
                     **({"split_bf16x3": 3} if which == "split_f32"
                        else {}),
                     **({"pack_bf16": packs} if packs else {})}
    want = flash_attention_ref(q, k, v, softcap=cap, **kw)
    free = flash_attention_ref(q, k, v, **kw)
    assert got.shape == q.shape and got.dtype == dtype
    assert got.stride() == q.stride() or view == "packed"
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-5
        assert (want - free).abs().max().item() > 100 * 2e-5
    else:
        assert _bf16_ulp_ratio(got, want) <= 1.0
        assert _bf16_ulp_ratio(free, want) > 100
    if q_offset < 0:
        assert not got[:, :, :-q_offset].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dtype", [
    (64, torch.bfloat16), (80, torch.bfloat16), (128, torch.bfloat16),
    (160, torch.bfloat16), (192, torch.bfloat16), (256, torch.bfloat16),
    (64, torch.float32), (128, torch.float32), (192, torch.float32),
    (256, torch.float32)])
def test_cuda_flash_attention_softcap_resources(cuda, dh, dtype):
    """Each capped instantiation spills nothing and keeps the cap-free
    one's block shape (threads, shared bytes, blocks an SM); the cap-free
    one spills nothing either."""
    from repro_torch.kernels.flash_attention import kernel as fk
    free = fk.tensor_core_resources(dh, dtype)
    cap = fk.tensor_core_resources(dh, dtype, softcap=True)
    assert free["local_bytes"] == 0 and cap["local_bytes"] == 0, (free, cap)
    for key in ("threads", "shared_bytes", "blocks_per_sm"):
        assert cap[key] == free[key], (key, free, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [-1.0, float("inf"), float("nan")])
def test_cuda_flash_attention_softcap_refuses_bad_caps(cuda, cap):
    """A cap that is neither 0 nor finite and positive raises before any
    launch: no counter moves."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fk
    t = torch.ones((1, 4, 70, 64), device=cuda, dtype=torch.bfloat16)
    n0 = dict(_build.counts())
    with pytest.raises(ValueError, match="softcap"):
        fk.flash_attention_fwd(t, t[:, :2], t[:, :2], softcap=cap)
    assert _build.counts() == n0
