"""Port: the page split of the CUDA paged-attention kernels, on the CPU.

The kernels split each (sequence, KV head)'s pages across blocks and merge
the splits' partial online-softmax states in a fixed order. The rule that
picks the split is host code and is tested here directly. The arithmetic of
split-then-combine is held here through a plain emulation (kept in this
file, not the package) against the JAX reference, at several split sizes,
on poisoned tables and rows with no valid token; the kernels themselves are
held against it on the card (``test_torch_cuda.py``).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.paged_attention import \
    paged_attention as j_attn  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pk  # noqa: E402
from repro_torch.kernels.paged_attention import ops as ka  # noqa: E402

NEG_INF = -1e30


# ---- the split rule --------------------------------------------------------

def test_split_rule_sees_the_shape_alone():
    assert list(inspect.signature(pk.split_pages).parameters) == \
        ["B", "Hkv", "npps"]
    # the serving paths: the synthetic serve (8 streams, 129 pages), the
    # model serve (4 streams, 65 pages), the jamba block (4 x 8 KV heads)
    assert pk.split_pages(8, 2, 129) == (8, 17)
    assert pk.split_pages(4, 2, 65) == (2, 33)
    assert pk.split_pages(4, 8, 65) == (8, 9)
    assert pk.split_pages(8, 2, 2048) == (121, 17)


@pytest.mark.parametrize("B", [1, 3, 8, 64, 300])
@pytest.mark.parametrize("Hkv", [1, 2, 8])
@pytest.mark.parametrize("npps", [1, 2, 3, 16, 65, 129, 2048])
def test_split_rule_covers_every_page_once(B, Hkv, npps):
    pps, n_split = pk.split_pages(B, Hkv, npps)
    assert pps >= 1 and n_split >= 1
    assert n_split * pps >= npps > (n_split - 1) * pps   # no empty split
    pages = [j for s in range(n_split)
             for j in range(s * pps, min((s + 1) * pps, npps))]
    assert pages == list(range(npps))
    if n_split > 1:
        assert pps >= pk.MIN_PAGES_PER_SPLIT
        # not more splits than the target needs
        want = -(-pk.TARGET_BLOCKS // (B * Hkv))
        assert n_split <= want
    if B * Hkv >= pk.TARGET_BLOCKS:
        assert (pps, n_split) == (npps, 1)


def test_split_rule_aims_for_two_blocks_a_sm():
    for B, Hkv, npps in ((8, 2, 129), (4, 2, 65), (4, 8, 65), (8, 2, 2048)):
        pps, n_split = pk.split_pages(B, Hkv, npps)
        assert B * Hkv * n_split >= pk.TARGET_BLOCKS, (B, Hkv, npps)
        assert B * Hkv * n_split < 2 * pk.TARGET_BLOCKS, (B, Hkv, npps)


def test_wrappers_pass_one_split_to_all_three_entry_points(monkeypatch):
    """The flat, hot-slot and async wrappers of a pinned pair (same q batch,
    same npps) hand their C entry points the same pages_per_split and
    n_split, and a workspace of B*Hkv*n_split*G*(dh+2) floats."""
    calls = {}

    def bind(stem, name, argtypes):
        assert argtypes == pk._ARGS
        return name

    def launch(fn, index, *args):
        assert len(args) == len(pk._ARGS) - 1          # the stream is added
        calls[fn] = args
        return 0

    monkeypatch.setattr(pk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "bind", bind)
    monkeypatch.setattr(_build, "launch", launch)
    B, Hkv, G, dh, ps, npps, n_slots = 4, 2, 8, 16, 4, 65, 70
    q = torch.zeros((B, Hkv, G, dh))
    pool = torch.zeros((B * npps, ps, Hkv, dh))
    hot = torch.zeros((B, n_slots, ps, Hkv, dh))
    table = torch.zeros((B, npps), dtype=torch.int32)
    ln = torch.ones(B, dtype=torch.int32)
    pk.paged_attention_fwd(q, pool, pool, table, ln)
    pk.paged_attention_hot_slots_fwd(q, hot, hot, table, ln)
    pk.paged_attention_hot_slots_async_fwd(q, hot, hot, table, ln)
    assert len(calls) == 3
    pps, n_split = pk.split_pages(B, Hkv, npps)
    assert n_split > 1
    for name, args in calls.items():
        # q k v table lengths out ws, B Hkv G dh page npps n_valid pps n_split
        # mma, sm_scale, bf16
        assert args[7:12] == (B, Hkv, G, dh, ps), name
        assert args[12] == npps and args[14:16] == (pps, n_split), name
        assert args[16:19] == (0, dh ** -0.5, 0), name
        assert args[6] is not None, name
        assert args[13] == (B * npps if name == "paged_attention_launch"
                            else n_slots)
    # one split: no workspace
    calls.clear()
    pk.paged_attention_fwd(q, pool, pool, table[:, :2], ln)
    assert calls["paged_attention_launch"][6] is None
    assert calls["paged_attention_launch"][14:16] == (2, 1)


@pytest.mark.parametrize("dtype,ps,dh,want", [
    (torch.bfloat16, 16, 128, True), (torch.bfloat16, 16, 64, True),
    (torch.bfloat16, 8, 128, False), (torch.bfloat16, 32, 128, False),
    (torch.bfloat16, 16, 80, False), (torch.float32, 16, 128, False)])
def test_route_rule_sees_dtype_and_shape(dtype, ps, dh, want):
    assert pk.tensor_core_route(dtype, ps, dh) is want


def test_wrappers_pass_one_route_to_all_three_entry_points(monkeypatch):
    """bf16 at page 16 and head dim 128: the flat, hot-slot and async
    wrappers all ask for the tensor-core route."""
    calls = {}
    monkeypatch.setattr(pk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(_build, "bind", lambda stem, name, argtypes: name)
    monkeypatch.setattr(_build, "launch",
                        lambda fn, index, *args: calls.update({fn: args})
                        or 0)
    B, Hkv, G, dh, ps, npps = 2, 2, 8, 128, 16, 5
    q = torch.zeros((B, Hkv, G, dh), dtype=torch.bfloat16)
    pool = torch.zeros((B * npps, ps, Hkv, dh), dtype=torch.bfloat16)
    hot = torch.zeros((B, npps, ps, Hkv, dh), dtype=torch.bfloat16)
    table = torch.zeros((B, npps), dtype=torch.int32)
    ln = torch.ones(B, dtype=torch.int32)
    pk.paged_attention_fwd(q, pool, pool, table, ln)
    pk.paged_attention_hot_slots_fwd(q, hot, hot, table, ln)
    pk.paged_attention_hot_slots_async_fwd(q, hot, hot, table, ln)
    assert [args[16] for args in calls.values()] == [1, 1, 1]
    assert [args[18] for args in calls.values()] == [1, 1, 1]


# ---- split-then-combine, emulated ------------------------------------------

def split_combine(q, k_pool, v_pool, table, lengths, pps, sm_scale):
    """The kernels' arithmetic at page granularity, in f32: each split runs
    the online softmax (_attend_page) over its valid pages in table order
    (a page with an invalid entry, or wholly past the length, is skipped),
    then the splits merge in split order. q [B,Hkv,G,dh]; pools
    [n_pages,page,Hkv,dh] -> [B,Hkv,G,dh] f32; a row with no valid token
    gives 0."""
    B, Hkv, G, dh = q.shape
    n_pages, ps = k_pool.shape[:2]
    npps = table.shape[1]
    n_split = -(-npps // pps)
    out = torch.zeros((B, Hkv, G, dh))
    for b in range(B):
        qs = q[b].float() * sm_scale                          # [Hkv, G, dh]
        length = int(lengths[b])
        parts = []
        for s in range(n_split):
            m = torch.full((Hkv, G), NEG_INF)
            l_ = torch.zeros((Hkv, G))
            acc = torch.zeros((Hkv, G, dh))
            for j in range(s * pps, min((s + 1) * pps, npps)):
                e = int(table[b, j])
                if j * ps >= length:
                    break
                if not 0 <= e < n_pages:
                    continue
                k = k_pool[e].float().transpose(0, 1)          # [Hkv, ps, dh]
                v = v_pool[e].float().transpose(0, 1)
                mask = (j * ps + torch.arange(ps)) < length
                sc = torch.where(mask, qs @ k.transpose(1, 2),
                                 torch.tensor(NEG_INF))       # [Hkv, G, ps]
                m_new = torch.maximum(m, sc.max(-1).values)
                m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
                p = torch.where(mask, torch.exp(sc - m_safe[..., None]), 0.0)
                corr = torch.where(m <= NEG_INF / 2, 0.0,
                                   torch.exp(m - m_safe))
                l_ = l_ * corr + p.sum(-1)
                acc = acc * corr[..., None] + p @ v
                m = m_new
            parts.append((m, l_, acc))
        m_star = torch.stack([p[0] for p in parts]).max(0).values
        ls, accs = torch.zeros((Hkv, G)), torch.zeros((Hkv, G, dh))
        for m_s, l_s, acc_s in parts:
            corr = torch.where(m_s <= NEG_INF / 2, 0.0,
                               torch.exp(m_s - m_star))
            ls = ls + corr * l_s
            accs = accs + corr[..., None] * acc_s
        out[b] = accs / torch.clamp(ls, min=1e-30)[..., None]
    return out


SPLIT_CASES = [  # B, Hq, Hkv, dh, page, npps
    (5, 8, 2, 16, 4, 7),
    (5, 4, 1, 32, 8, 5),
]


def _case(B, Hq, Hkv, dh, ps, npps, seed):
    """Inputs with poisoned entries, a row whose every entry is invalid, a
    row of length 0, a row whose second 2-page split is masked whole and a
    row whose length ends inside its first page."""
    rng = np.random.default_rng(seed)
    n_pages = B * npps + 3
    q = rng.standard_normal((B, 1, Hq, dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, Hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, Hkv, dh)).astype(np.float32)
    pt = rng.integers(0, n_pages, (B, npps)).astype(np.int32)
    ln = rng.integers(ps * (npps - 1) + 1, ps * npps + 1, B).astype(np.int32)
    pt[0, 1], pt[0, -1] = -1, n_pages + 2                 # poisoned entries
    pt[1] = -1                                            # no valid token
    pt[2, 2:4] = -7                                       # split 1 of P = 2
    ln[3] = ps // 2                                       # ends in page 0
    ln[4] = 0                                             # nothing to attend
    return q, kp, vp, pt, ln


@pytest.mark.parametrize("B,Hq,Hkv,dh,ps,npps", SPLIT_CASES)
@pytest.mark.parametrize("pps", [1, 2, 3, "npps"])
def test_split_combine_matches_the_jax_reference(B, Hq, Hkv, dh, ps, npps,
                                                  pps):
    pps = npps if pps == "npps" else pps
    q, kp, vp, pt, ln = _case(B, Hq, Hkv, dh, ps, npps, seed=pps)
    want = np.asarray(j_attn(*(jnp.asarray(a) for a in (q, kp, vp, pt, ln)),
                             use_kernel=False))
    plain = ka.paged_attention(*(torch.from_numpy(a)
                                 for a in (q, kp, vp, pt, ln)),
                               use_kernel=False).numpy()
    got = split_combine(torch.from_numpy(q[:, 0]).reshape(B, Hkv, Hq // Hkv,
                                                           dh),
                        torch.from_numpy(kp), torch.from_numpy(vp),
                        torch.from_numpy(pt), torch.from_numpy(ln), pps,
                        1.0 / dh ** 0.5).reshape(B, 1, Hq, dh).numpy()
    ok = (pt >= 0) & (pt < kp.shape[0])
    tok = np.repeat(ok, ps, 1) & (np.arange(npps * ps)[None] < ln[:, None])
    live = tok.any(1)
    assert live.sum() == B - 2 and not live[1] and not live[4]
    np.testing.assert_allclose(got[live], want[live], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[live], plain[live], atol=2e-5, rtol=0)
    # the documented difference: no valid token gives 0 here and in the
    # kernels, the uniform average of V in the plain versions
    assert not got[~live].any()
