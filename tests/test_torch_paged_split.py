"""The split-KV scheme of the port's paged attention kernel, on the CPU.

``csrc/paged_attention.cu`` spreads each slot's keys over P blocks, each
writing fp32 partials ``(m, l, acc)``, and combines them in split order.
The kernel runs only on the card; here a torch mirror of the same scheme
(:func:`split_kv_mirror`: the kernel's plan and split ranges, partials
per split, the fixed-order combine) is held to the JAX package's Pallas
kernel in interpret mode, and the plan's properties are checked. The
tensor-core arithmetic the kernel could use for QK^T and PV is emulated
too: how many TF32 or bf16 terms keep the kernel's 1e-4 gate at D=128.
"""
import ctypes
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build
from repro_torch.kernels import gathered_matmul as tgm
from repro_torch.kernels import paged_attention as tpa

NEG = -1e30  # the kernels' running-max seed


def split_kv_mirror(q, k_pool, v_pool, tables, qpos, *, splits, chunk):
    """The kernel's scheme in torch, fp32: for every slot, the keys up to
    its largest qpos cut into ``splits`` ranges by
    :func:`paged_split_range`; per split and row the masked softmax
    partials ``m`` (the -1e30 seed where nothing is visible), ``l`` and
    ``acc``; then ``out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i``
    in split order over the splits with ``l_i > 0``."""
    b, s, h, d = q.shape
    n_pages, bs, kv, _ = k_pool.shape
    nb = tables.shape[1]
    g = h // kv
    tbl = tables.long().clamp(0, n_pages - 1)
    kk = k_pool[tbl].reshape(b, nb * bs, kv, d).float().repeat_interleave(g, dim=2)
    vv = v_pool[tbl].reshape(b, nb * bs, kv, d).float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bshd,bthd->bsht", q.float(), kk) * (1.0 / math.sqrt(d))
    t = torch.arange(nb * bs)
    out = torch.empty((b, s, h, d), dtype=torch.float32)
    for bi in range(b):
        mq = int(qpos[bi].max())
        n_keys = 0 if mq < 0 else min(nb * bs, mq + 1)
        parts = []
        for sp in range(splits):
            lo, hi = tpa.paged_split_range(sp, splits, n_keys, chunk)
            vis = (t >= lo) & (t < hi) & (t[None, :] <= qpos[bi].long()[:, None])  # [S, T]
            sc = scores[bi].masked_fill(~vis[:, None, :], NEG)  # [S, H, T]
            m = sc.max(dim=-1).values
            p = torch.where(vis[:, None, :], torch.exp(sc - m[..., None]), 0.0)
            parts.append((m, p.sum(-1), torch.einsum("sht,thd->shd", p, vv[bi])))
        mx = torch.full((s, h), NEG)
        for m, l, _ in parts:
            mx = torch.where(l > 0, torch.maximum(mx, m), mx)
        num, den = torch.zeros((s, h, d)), torch.zeros((s, h))
        for m, l, acc in parts:
            w = torch.where(l > 0, torch.exp(m - mx), 0.0)
            num = num + torch.where(l[..., None] > 0, w[..., None] * acc, 0.0)
            den = den + w * l
        out[bi] = num / den[..., None]
    return out


def _case(seed, *, b, s, h, kv, d, n_pages, bs, nb, offs):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((n_pages, bs, kv, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, bs, kv, d)).astype(np.float32)
    tables = rng.permutation(n_pages)[: b * nb].reshape(b, nb).astype(np.int32)
    qpos = (np.asarray(offs)[:, None] + np.arange(s)).astype(np.int32)
    return q, k, v, tables, qpos


def _jax(q, k, v, tables, qpos):
    out = jops.paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables), jnp.asarray(qpos)
    )
    return np.asarray(out, np.float32)


# (S, H, KV, bs, NB, chunk, splits, slot offsets): the horizons fall
# mid-page (offsets 5, 2), on a page boundary (7 = 2*4 - 1) and deep; with
# 3- and 4-key chunks some slots have fewer chunks than splits, so a split
# sees no key at all
SPLIT_CASES = [
    (1, 4, 2, 4, 6, 4, 3, [5, 7, 22]),
    (1, 4, 2, 4, 6, 4, 8, [2, 7, 23]),
    (2, 4, 2, 4, 5, 8, 2, [1, 9, 18]),
    (3, 4, 4, 4, 6, 3, 5, [0, 6, 13]),
    (1, 8, 2, 4, 4, 4, 1, [3, 11, 15]),
]


@pytest.mark.parametrize("s,h,kv,bs,nb,chunk,splits,offs", SPLIT_CASES)
def test_split_kv_mirror_matches_jax(s, h, kv, bs, nb, chunk, splits, offs):
    """Partials per split, then the fixed-order combine, equal the Pallas
    kernel (interpret mode) at D=32, fp32, rtol = atol = 1e-5."""
    b, d = len(offs), 32
    q, k, v, tables, qpos = _case(
        31, b=b, s=s, h=h, kv=kv, d=d, n_pages=b * nb + 2, bs=bs, nb=nb, offs=offs)
    n_keys = [min(nb * bs, o + s) for o in offs]
    empty = [sp for nk in n_keys for sp in range(splits)
             if tpa.paged_split_range(sp, splits, nk, chunk)[0]
             == tpa.paged_split_range(sp, splits, nk, chunk)[1]]
    if splits > min(-(-nk // chunk) for nk in n_keys):
        assert empty  # the case exercises a split that sees no key
    out = split_kv_mirror(
        *(torch.from_numpy(a) for a in (q, k, v, tables, qpos)), splits=splits, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), _jax(q, k, v, tables, qpos), rtol=1e-5, atol=1e-5)
    ref = tpa.paged_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, tables, qpos)))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_split_kv_mirror_at_the_plans_splits_matches_jax():
    """The plan's own P and chunk at D=32 with a long table: several
    splits, each a whole number of 128-key chunks."""
    b, s, h, kv, d, bs, nb = 2, 1, 4, 2, 32, 16, 40
    plan = tpa.paged_split_plan(b, s, h, kv, d, nb, bs)
    assert plan.splits > 1 and plan.chunk == 128
    q, k, v, tables, qpos = _case(
        32, b=b, s=s, h=h, kv=kv, d=d, n_pages=b * nb, bs=bs, nb=nb, offs=[300, 637])
    out = split_kv_mirror(*(torch.from_numpy(a) for a in (q, k, v, tables, qpos)),
                          splits=plan.splits, chunk=plan.chunk)
    np.testing.assert_allclose(out.numpy(), _jax(q, k, v, tables, qpos), rtol=1e-5, atol=1e-5)


def test_split_kv_mirror_ignores_garbage_past_the_horizon():
    """Table entries past every slot's horizon (999, -7) are clipped and
    never read by any split: the output is unchanged."""
    b, s, h, kv, d, bs, nb = 2, 1, 4, 2, 32, 4, 5
    q, k, v, tables, qpos = _case(
        33, b=b, s=s, h=h, kv=kv, d=d, n_pages=b * nb, bs=bs, nb=nb, offs=[2, 5])
    bad = tables.copy()
    bad[:, 2:] = [[999], [-7]]
    args = [torch.from_numpy(a) for a in (q, k, v, tables, qpos)]
    good = split_kv_mirror(*args, splits=3, chunk=4)
    args[3] = torch.from_numpy(bad)
    assert torch.equal(good, split_kv_mirror(*args, splits=3, chunk=4))


@pytest.mark.parametrize("n_keys,splits,chunk", [
    (nk, p, c) for nk, p, c in itertools.product((0, 1, 31, 32, 33, 160, 161, 2048), (1, 2, 5, 33),
                                                  (32, 128))
])
def test_split_ranges_tile_the_keys_in_whole_chunks(n_keys, splits, chunk):
    """Every visible key lies in exactly one split; splits start on whole
    chunks and end on one or at the slot's last key; their sizes differ
    by at most one chunk; a split is empty only where the slot has fewer
    chunks than splits (or no key at all)."""
    ranges = [tpa.paged_split_range(sp, splits, n_keys, chunk) for sp in range(splits)]
    covered = [t for lo, hi in ranges for t in range(lo, hi)]
    assert covered == list(range(n_keys))
    n_chunks = -(-n_keys // chunk)
    sizes = []
    for lo, hi in ranges:
        assert lo % chunk == 0 and (hi % chunk == 0 or hi == n_keys)
        sizes.append(-(-(hi - lo) // chunk))
    assert max(sizes) - min(sizes) <= 1
    assert sum(1 for lo, hi in ranges if lo == hi) == max(0, splits - n_chunks)


@pytest.mark.parametrize("b,s,h,kv,d,nb,bs", [
    (4, 1, 16, 2, 128, 10, 16), (4, 1, 16, 2, 128, 128, 16), (4, 32, 16, 2, 128, 10, 16),
    (4, 32, 16, 2, 128, 128, 16), (1, 1, 16, 2, 128, 1, 16), (64, 1, 16, 2, 128, 128, 16),
    (2, 12, 4, 2, 32, 4, 4), (8, 1, 4, 4, 32, 3, 8), (2, 5, 16, 2, 128, 6, 8),
])
def test_split_plan_fills_the_card_with_a_bounded_grid(b, s, h, kv, d, nb, bs):
    """Row tiles of 8 at decode width, 64 (tensor cores) from 64 rows on,
    else 16, covering every row; at least one chunk of the table a split;
    one split where the blocks already fill a wave of the 132 SMs;
    otherwise a grid of at most two waves, and short of one only where
    the table's chunks run out."""
    plan = tpa.paged_split_plan(b, s, h, kv, d, nb, bs)
    rows = s * (h // kv)
    assert plan.row_tile == (8 if rows <= 8 else 64 if rows >= 64 else 16)
    assert plan.row_tiles * plan.row_tile >= rows > (plan.row_tiles - 1) * plan.row_tile
    assert plan.chunk == 4096 // d
    chunks = -(-nb * bs // plan.chunk)
    base = b * kv * plan.row_tiles
    assert 1 <= plan.splits <= max(1, chunks)
    if base >= 132:
        assert plan.splits == 1
    else:
        assert base * plan.splits <= 2 * 132
        assert base * plan.splits >= 132 or plan.splits == chunks
    assert ("mma" in plan.variant) == (plan.row_tile == 64)
    assert f"{plan.row_tile}-row tiles" in plan.variant and f"P={plan.splits}" in plan.variant


def test_argtypes_match_the_c_entry_point():
    """The wrapper's ctypes signature is the one ``extern "C"
    paged_attention_launch`` takes (a mismatch shows only on the card)."""
    src = (build.CSRC / "paged_attention.cu").read_text()
    head = src[src.index('extern "C" int paged_attention_launch('):]
    params = head[head.index("(") + 1:head.index(")")].split(",")
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    want = [kinds[" ".join(p.replace("const ", "").split()[:-1])] for p in params]
    assert tpa._ARGTYPES == want


def test_row_tile_override():
    """A forced row tile re-plans the tiles and splits around it; the
    kernel has no other tile."""
    plan = tpa.paged_split_plan(4, 32, 16, 2, 128, 10, 16, row_tile=16)
    assert (plan.row_tile, plan.row_tiles, plan.splits) == (16, 16, 2)
    assert "simt" in plan.variant
    with pytest.raises(ValueError, match="row_tile"):
        tpa.paged_split_plan(4, 32, 16, 2, 128, 10, 16, row_tile=32)


def test_main_path_plans():
    """qwen2.5-3b's serving shapes: decode (S=1, G=8) takes 8-row tiles
    and splits 160-token slots into 5 one-chunk splits (40 blocks, where
    a whole slot a block gave 8), 2048-token ones into 33; a 32-row
    prefill chunk (256 rows a KV head) takes four 64-row tensor-core
    tiles, 32 blocks, and splits in five (eight over 128 pages)."""
    dec = tpa.paged_split_plan(4, 1, 16, 2, 128, 10, 16)
    assert (dec.row_tile, dec.row_tiles, dec.splits, dec.chunk) == (8, 1, 5, 32)
    assert tpa.paged_split_plan(4, 1, 16, 2, 128, 128, 16).splits == 33
    pre = tpa.paged_split_plan(4, 32, 16, 2, 128, 10, 16)
    assert (pre.row_tile, pre.row_tiles, pre.splits) == (64, 4, 5)
    assert tpa.paged_split_plan(4, 32, 16, 2, 128, 128, 16).splits == 8


# --- the arithmetic of QK^T and PV on the tensor cores, emulated -------


def _attention_terms(q, k, v, qk, pv):
    """Softmax attention of one head, ``q [S, D]``, ``k, v [T, D]``, with
    the two products computed by ``qk(a, b)`` and ``pv(a, b)`` (each an
    ``a @ b`` emulation)."""
    scores = qk(q, k.T) / math.sqrt(q.shape[1])
    p = torch.softmax(scores, dim=-1)
    return pv(p, v)


def _attention_case(seed, s=64, t=160, d=128):
    """Seeded normal q, k, v of one head: ``s`` query rows over ``t`` keys
    (160: the main path's 10-page slots; over more keys the errors of
    the products average out further)."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    return q, k, v


def _gate(out, plain):
    return (out.double() - plain).abs().max().item(), 1e-4 * max(1.0, plain.abs().max().item())


def test_tf32_terms_of_qk_and_pv_over_fp32_pools():
    """bf16 q over fp32 pools (the main path): q is exact in TF32, so
    QK^T takes two TF32 products (q·k_big + q·k_small) and PV three
    (3xTF32); that holds the 1e-4 gate at D=128 over 160 keys, while
    one term for either product misses it."""
    q, k, v = _attention_case(40)
    q = q.to(torch.bfloat16).float()
    assert torch.equal(tgm.tf32_rna(q), q)  # a bf16 value is a TF32 value
    plain = _attention_terms(q.double(), k.double(), v.double(), torch.matmul, torch.matmul)

    def terms(n):
        return lambda a, b: tgm.matmul_tf32_terms(a, b, terms=n)

    err, limit = _gate(_attention_terms(q, k, v, terms(2), terms(3)), plain)
    assert err <= limit
    err, limit = _gate(_attention_terms(q, k, v, terms(1), terms(3)), plain)
    assert err > limit
    err, limit = _gate(_attention_terms(q, k, v, terms(2), terms(1)), plain)
    assert err > limit


def test_bf16_split_of_pv_over_bf16_pools():
    """bf16 q over bf16 pools: QK^T is one exact-input bf16 product; P is
    fp32 and V exact in bf16, so PV takes P split into bf16 hi + lo
    (two bf16 products); that holds the 1e-4 gate at D=128, one product
    of P rounded to bf16 misses it."""
    q, k, v = (x.to(torch.bfloat16).float() for x in _attention_case(41))
    plain = _attention_terms(q.double(), k.double(), v.double(), torch.matmul, torch.matmul)

    def pv(n):
        return lambda a, b: tgm.matmul_bf16_split(a, b, terms=n)

    err, limit = _gate(_attention_terms(q, k, v, torch.matmul, pv(2)), plain)
    assert err <= limit
    err, limit = _gate(_attention_terms(q, k, v, torch.matmul, pv(1)), plain)
    assert err > limit


def test_two_term_tf32_equals_three_terms_when_a_is_tf32():
    """``terms=2`` drops only ``a``'s small part, which is 0 for a TF32
    (or bf16) ``a``: then it is exactly the 3-term product."""
    q, k, _ = _attention_case(42, s=8, t=64)
    q = tgm.tf32_rna(q)
    assert torch.equal(tgm.matmul_tf32_terms(q, k.T, terms=2),
                       tgm.matmul_tf32_terms(q, k.T, terms=3))
