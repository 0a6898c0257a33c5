"""Shared model layers: plain functions on tensors and dict params.

The twin of ``repro.models.layers`` for the decoder stacks (training and
paged serving) and the CNNs' convolutions. Parameters keep the JAX
package's layouts (dense weights are ``[d_in, d_out]``, conv filters
OIHW), so a JAX param tree converts array for array. Every projection
goes through :func:`dense_apply` (the ssProp linear layer,
:func:`repro_torch.core.dense.sparse_dense`) and every convolution
through :func:`conv_apply` (:func:`repro_torch.core.conv.sparse_conv2d`).

Every call site carries a site name (``site=``): a plain
:class:`~repro_torch.core.policy.SsPropPolicy` ignores it, while a
:class:`~repro_torch.core.policy.SitePolicies` table gives each named
site its own policy. Serving passes no policy (dense) and asks for no
gradient, so its projections are plain matmuls.

On a device mesh (``mesh=``, ``launch/mesh.py::Mesh``) the params are
this rank's shards (``dist/sharding.py``): attention runs the q heads its
q columns touch (:func:`head_span`; the columns may cut across heads) and
the MLP its local ``d_ff``; q/k/v/up/gate are column-parallel behind
``copy_to_model``, o/down row-parallel ahead of ``reduce_from_model``,
the embedding and the tied unembedding vocab-parallel
(``dist/parallel.py``). Where ``fit_spec`` drops ``model`` from a leaf
(the model size divides none of its dims) every rank holds it whole and
runs its product alike (:func:`model_splits`). ``mesh=None`` is the
one-device model.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import backward
from repro_torch.core.conv import sparse_conv2d
from repro_torch.core.dense import sparse_dense
from repro_torch.core.policy import DENSE, PolicyLike, policy_for
from repro_torch.dist import parallel
from repro_torch.kernels import ops as kops
from repro_torch.kernels.paged_attention import paged_attention_ref

# ----------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------


def dense_init(gen, d_in, d_out, *, bias=False, dtype=torch.bfloat16, scale=None, device="cuda"):
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    p = {"w": (w * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_apply(p, x, policy: PolicyLike = DENSE, key=None, site: str = "", *, mesh=None,
                split: str = "col"):
    """The ssProp linear layer at one site. On a mesh ``split`` says how
    the rank holds it: ``"col"`` its output columns (its slice of the
    replicated bias added; ``x`` already behind ``copy_to_model``),
    ``"row"`` its input rows (the partial product summed over ``model``;
    no bias), ``"gather"`` a column shard that does not line up with
    heads, all-gathered on use into the full product, computed alike on
    every model rank, ``"rep"`` the whole leaf (``fit_spec`` dropped
    ``model`` from it, or serving gathered it at load), the full product
    computed alike on every model rank."""
    with backward.scope(site):
        return _dense_apply(p, x, policy, key, site, mesh, split)


def _dense_apply(p, x, policy, key, site, mesh, split):
    b = p.get("b")
    if mesh is None:
        return sparse_dense(x, p["w"], b, policy=policy_for(policy, site), key=key)
    w = p["w"]
    if split == "col" and b is not None:
        b = parallel.slice_for_model(b, mesh)
    elif split == "gather":
        w = parallel.gather_from_model(w, mesh)
    elif split == "row" and b is not None:
        raise NotImplementedError(f"{site}: a row-parallel bias on a mesh")
    y = sparse_dense(x, w, b, policy=policy_for(policy, site), key=key,
                     mesh=parallel.SiteMesh(mesh, col=split == "col", site=mesh.prefix + site))
    return parallel.reduce_from_model(y, mesh) if split == "row" else y


def conv2d_init(gen, c_out, c_in, k, *, bias=False, dtype=torch.float32, device="cuda"):
    """Kaiming-normal OIHW conv params ``{"w"[, "b"]}``, drawn from the
    ``torch.Generator`` ``gen``."""
    fan_in = c_in * k * k
    w = torch.randn((c_out, c_in, k, k), generator=gen, dtype=torch.float32, device=device)
    p = {"w": (w * math.sqrt(2.0 / fan_in)).to(dtype)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def conv_apply(
    p,
    x,
    policy: PolicyLike,
    *,
    stride=1,
    padding=0,
    dilation=1,
    groups=1,
    key=None,
    site: str = "",
):
    """The single conv call site the CNN models share: params dict in,
    ssProp-backward conv out."""
    with backward.scope(site):
        return sparse_conv2d(
            x,
            p["w"],
            p.get("b"),
            stride=stride,
            padding=padding,
            dilation=dilation,
            groups=groups,
            policy=policy_for(policy, site),
            key=key,
        )


def rmsnorm_init(d, dtype=torch.bfloat16, device="cuda"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin), each [B, S, 1, D/2], of the rotation at ``positions``
    ([B, S] or [S]). They depend on the positions only, so a step computes
    them once for all its layers."""
    freqs = rope_freqs(head_dim, theta, positions.device)  # [D/2]
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # [B, S, D/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, angles) -> torch.Tensor:
    """x: [B, S, H, D]; ``angles``: :func:`rope_angles` of x's positions.
    Half-split rotation."""
    cos, sin = angles
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------


def attn_init(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    d, hd = cfg.d_model, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "q": dense_init(gen, d, cfg.n_heads * hd, bias=cfg.qkv_bias, **kw),
        "k": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw),
        "v": dense_init(gen, d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias, **kw),
        "o": dense_init(
            gen, cfg.n_heads * hd, d,
            scale=1.0 / math.sqrt(2 * cfg.n_layers * cfg.n_heads * hd), **kw,
        ),
    }


def paged_write_index(block_tables, positions, token_valid, block_size, sink):
    """Where this step's tokens go in a page pool: ``(rows, cols, (page,
    off))``, so that token ``[rows, cols]`` is written at ``pool[page,
    off]``. The token at absolute position p of slot b sits in page
    ``block_tables[b, p // block_size]`` (block index clipped to the
    table, as the JAX package does) at offset ``p % block_size``. Every
    ``[B, S]`` token gets an index (rows and cols are whole slices): an
    invalid token goes to the pool's ``sink`` page, which no block table
    names (``models/model.py::init_paged_cache``). That is the static
    form of the JAX package's out-of-range ``mode="drop"`` scatter: its
    shapes do not depend on the data, so a step can be captured."""
    logical = positions.long()
    blk = torch.clamp(logical // block_size, 0, block_tables.shape[1] - 1)
    page = torch.gather(block_tables.long(), 1, blk)  # [B,S]
    every = slice(None)
    return every, every, (torch.where(token_valid, page, sink), logical % block_size)


def slot_write_index(positions, token_valid, t, lo: int = 0, t_loc: int | None = None):
    """Where this step's real tokens go in a contiguous cache ``[B, t,
    KV, hd]``: ``(rows, cols, (rows, tgt))``, so that token ``[rows[i],
    cols[i]]`` is written at ``cache[rows[i], tgt[i]]``, its absolute
    position. Invalid tokens and positions past the cache are left out,
    as the JAX package's out-of-range ``mode="drop"`` scatter does. A
    rank that holds only positions ``[lo, lo + t_loc)`` of the cache (its
    sequence dim split over a mesh axis) writes only the tokens there, at
    ``tgt - lo``."""
    keep = token_valid & (positions < t)
    if t_loc is not None:
        keep = keep & (positions >= lo) & (positions < lo + t_loc)
    rows, cols = keep.nonzero(as_tuple=True)
    return rows, cols, (rows, positions.long()[rows, cols] - lo)


class SeqSplit(NamedTuple):
    """A sequence dim split over a mesh axis: this rank holds the
    ``index``-th of ``n`` equal slices, the axis's ranks forming ``group``.
    A contiguous decode cache's (``"model"`` under ``decode_seq_shard``,
    ``"data"`` where the batch cannot take it), whose attention combines
    the group's partial softmaxes; or a training step's tokens
    (``models/model.py::BatchLayout``: a data axis the global batch cannot
    take), whose attention gathers the group's K/V."""

    axis: str
    group: Any
    n: int
    index: int


class KvPlace(NamedTuple):
    """How a rank of a mesh writes and reads a decode step's K/V, beside
    its rows: ``gather`` the mesh whose data ranks' new K/V rows every rank
    writes (the paged pool, replicated over ``data`` while the slots are
    split), with ``write_index`` the step's full-batch write index; ``seq``
    the contiguous cache's sequence split, or ``None``."""

    write_index: Any = None
    gather: Any = None
    seq: SeqSplit | None = None


class DecodeGeom(NamedTuple):
    """What every attention layer of a decode step shares
    (``transformer._decode_geometry``): the rank's rows' int32 query
    positions, the RoPE angles, the K/V write index, the rows' block
    tables (paged) and the :class:`KvPlace` fields."""

    qpos: torch.Tensor
    rope: Any
    write_index: Any
    block_tables: torch.Tensor | None = None
    gather: Any = None
    seq: SeqSplit | None = None


def partial_attention(q, k, v, qpos, t0: int):
    """The per-head partial softmax of ``q [B,S,H,D]`` over a slice of a
    contiguous cache ``k/v [B,T,KV,D]`` that holds positions ``t0 ..
    t0+T-1``: scores in fp32, future positions at -1e30 as in
    :func:`~repro_torch.kernels.paged_attention.paged_attention_ref`.
    Returns ``(m [B,S,H], s [B,S,H], o [B,S,H,D])``: each head's largest
    score, the sum of ``exp(score - m)`` and the values so weighted
    (:func:`repro_torch.dist.parallel.softmax_combine` joins the slices)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    kk = k.float().repeat_interleave(h // kv, dim=2)
    vv = v.float().repeat_interleave(h // kv, dim=2)
    pos = t0 + torch.arange(t, device=q.device)
    mask = pos[None, None, :] <= qpos.long()[:, :, None]  # [B, S, T]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kk) * (1.0 / math.sqrt(d))
    scores = scores.masked_fill(~mask[:, None], -1e30)
    m = scores.amax(dim=-1)  # [B,H,S]
    p = torch.exp(scores - m[..., None])
    o = torch.einsum("bhst,bthd->bshd", p, vv)
    return m.transpose(1, 2), p.sum(dim=-1).transpose(1, 2), o


def seq_split_attention(q, k, v, qpos, seq: SeqSplit, heads=None):
    """Attention over a contiguous cache whose sequence dim is split over
    ``seq``'s group: this rank scores its slice and the group's partials
    combine in rank order. Over ``model`` (``decode_seq_shard``: every
    rank holds every KV head) ``q`` is every head (the model ranks' q
    columns gathered) and ``heads`` the ``[lo, hi)`` the rank keeps of the
    result, its head span; over ``data`` the rank's q heads and KV heads
    are its model rank's. Returns fp32 ``[B,S,H_loc,D]``."""
    m, s, o = partial_attention(q, k, v, qpos, seq.index * k.shape[1])
    return parallel.softmax_combine(m, s, o, seq.group, seq.n, heads)


def masked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024, q_offset: int = 0,
                     q_pos=None, kv_pos=None):
    """Full-sequence attention, blocked over query chunks of ``q_chunk``.

    q [B,S,H,D], k/v [B,T,KV,D] (GQA: each KV head serves H/KV query
    heads). Scores and softmax in fp32; with ``causal`` (the decoder's
    self-attention) future positions are masked at -1e30, without it
    (the encoder, cross-attention) every key is seen, as the JAX
    package's ``masked_attention`` without a cache. ``q_offset`` is the
    absolute position of ``q[:, 0]`` (the keys sit at ``0 .. T-1``): a
    rank's block of a sequence split over a mesh axis. Where a rank's
    positions are not one run (the VLM's patch block and token block),
    ``q_pos [S]`` and ``kv_pos [T]`` give every query's and key's absolute
    position instead. Returns [B,S,H,D] in q.dtype.
    """
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    k_t = k.float().repeat_interleave(h // kv, dim=2).permute(0, 2, 3, 1)  # [B,H,D,T]
    v_h = v.float().repeat_interleave(h // kv, dim=2).transpose(1, 2)  # [B,H,T,D]
    if kv_pos is None:
        kv_pos = torch.arange(t, device=q.device)
    outs = []
    for c0 in range(0, s, q_chunk):
        qc = q[:, c0 : c0 + q_chunk].float().transpose(1, 2)  # [B,H,qc,D]
        scores = (qc @ k_t) * scale  # [B,H,qc,T]
        if causal:
            if q_pos is None:
                qp = torch.arange(q_offset + c0, q_offset + c0 + qc.shape[2], device=q.device)
            else:
                qp = q_pos[c0:c0 + qc.shape[2]]
            scores = scores.masked_fill(kv_pos[None, :] > qp[:, None], -1e30)
        outs.append((torch.softmax(scores, dim=-1) @ v_h).transpose(1, 2))  # [B,qc,H,D]
    return torch.cat(outs, dim=1).to(q.dtype)


def attn_apply(
    p,
    x,
    cfg,
    policy: PolicyLike = DENSE,
    *,
    rope,
    causal=True,
    kv_cache=None,
    geom: DecodeGeom | None = None,
    paged_kernel=True,
    x_kv=None,
    site: str = "attn",
    mesh=None,
):
    """Self- or cross-attention, full-sequence or over a KV cache.

    x [B,S,d]; ``rope`` is :func:`rope_angles` of the tokens' positions,
    the same at every layer of a step, so the stack makes it once, or
    ``None`` for no rotation. The projections look their policies up as
    ``{site}/q`` ... ``{site}/o`` ("attn" in the decoder stack and the
    encoder, "self" / "cross" in the cross-decoder).

    ``x_kv [B,T,d]`` makes it cross-attention: K/V are projections of
    ``x_kv``, unrotated and uncached, every key seen (the JAX package's
    ``x_kv`` with ``use_rope=False``, which the cross-decoder passes).
    Where the step's sequence is split (``mesh.seq``), ``x_kv`` (the
    encoder's output) is whole and alike on every rank of the sequence
    group: the k/v products run on the view over the batch axes alone
    (``BatchLayout.batch_mesh``), and their outputs' gradient, a partial
    sum of the rank's queries, is summed over the group before their
    sites' backward (``parallel.sum_grad_over_seq``), so their importance,
    kept channels, dW and dX are the one-device run's, alike on the group.

    Without ``kv_cache`` (training, the encoder): :func:`masked_attention`
    over the sequence itself, causal or not by ``causal``. Where the
    step's sequence is split over a data axis (``mesh.seq``, a
    :class:`SeqSplit`; ``rope`` is then taken at the block's global
    positions) the rank's queries attend to every rank's K/V, all-gathered
    in rank order (``dist/parallel.py::gather_seq``: the gradient of each
    rank's K/V block summed over the group), causally masked at the global
    positions (the VLM's a position vector a side, ``BatchLayout.positions``
    and ``group_positions``: a rank holds a patch block and a token block).

    With ``kv_cache`` = dict(k, v) (serving), ``geom`` is the step's
    :class:`DecodeGeom`: ``geom.qpos [B,S]`` int32 is each token's
    absolute position in its slot, and this step's K/V are written **in
    place** (cast to the cache dtype) at ``geom.write_index``, which
    leaves out the invalid tokens (the paged pool sends them to its sink
    page):

    * with ``geom.block_tables``, the paged layout: ``kv_cache`` is one
      layer's page pool ``[n_pages, bs, KV, D]`` shared by all slots, and
      slot b's token at position p lives in page ``block_tables[b, p //
      bs]`` at offset ``p % bs`` (``write_index`` from
      :func:`paged_write_index`). On a data mesh the pool is the same on
      every data rank (the reference's replicated page axis): with
      ``geom.gather`` each rank all-gathers the data ranks' new K/V rows
      (one collective a layer) and writes them all, at the full batch's
      write index. ``paged_kernel=True`` (the default)
      attends through the paged-attention kernel, which reads the pages
      in place; ``paged_kernel=False`` takes the gather route, the
      kernel's plain version
      :func:`~repro_torch.kernels.paged_attention.paged_attention_ref`;
    * without, the contiguous layout: ``kv_cache`` is ``[B, T, KV, D]``,
      one row set a slot (``write_index`` from :func:`slot_write_index`).
      Attention is the plain per-slot causal one, as in the JAX package,
      which computes this route outside any kernel: the cache read as a
      pool of B pages of T tokens, slot b's table ``[b]``. With
      ``geom.seq`` the rank holds one slice of the sequence dim: it writes
      only the tokens whose positions it holds, scores its slice, and the
      group's partial softmaxes combine (:func:`seq_split_attention`).
      Over ``model`` (``decode_seq_shard``) the k/v projections are held
      whole on every rank (the reference's ``replicate_kv``) and every KV
      head is cached; the output keeps the rank's heads for the
      row-parallel ``o``.

    On a ``mesh`` the rank runs the heads of its :func:`head_span`: q
    column-parallel on its own columns, and where those cut across heads
    all-gathered over ``model`` and the span's heads taken
    (``parallel.gather_span_from_model``, whose backward sums the ranks'
    partial gradients of a shared head); K/V the local k/v columns where
    they are the span's KV heads, else the full k/v products computed
    alike on every model rank, their gradient summed over ``model`` by
    ``copy_to_model`` (each rank's q heads reach only their KV heads), and
    the span's KV heads taken. The output, flattened, gives the rank's
    own columns to its rows of the row-parallel ``o``. The KV cache holds
    the span's KV heads (:func:`kv_range`: where the model size does not
    divide the KV heads, a head is held by every rank that reads it, the
    layout of the reference's ``replicate_kv``). Where ``model`` does not
    divide q's columns, every rank runs every head on whole q/k/v/o, no
    collective. Cross-attention projects K/V from ``x_kv``, replicated
    over ``model``, behind ``copy_to_model``.

    Returns (out [B,S,d], kv_cache).
    """
    b, s, _ = x.shape
    hd = cfg.head_dim
    src = x if x_kv is None else x_kv
    t = src.shape[1]
    span = mesh_head_span(cfg, mesh)
    seq = getattr(mesh, "seq", None)
    kv_mesh = mesh.layout.batch_mesh(mesh) if seq is not None and x_kv is not None else mesh
    seq_model = geom is not None and geom.seq is not None and geom.seq.axis == "model"
    xm = parallel.copy_to_model(x, mesh) if span.split else x
    q = dense_apply(p["q"], xm, policy, site=f"{site}/q", mesh=mesh,
                    split="col" if span.split else "rep")
    if seq_model and span.split:  # every head: each rank scores its slice of every head's keys
        q = parallel.all_gather(q, mesh.model_group, mesh.model, dim=-1)
    elif span.gather_q:
        spans = [tuple(hd * e for e in head_span(cfg, mesh.model, r).q)
                 for r in range(mesh.model)]
        q = parallel.gather_span_from_model(q, mesh, spans)
    q = q.reshape(b, s, -1, hd)
    if seq_model:
        # every KV head on every model rank, from the replicated k/v kernels
        k, v = (dense_apply(p[n], src, policy, site=f"{site}/{n}").reshape(b, t, -1, hd)
                for n in ("k", "v"))
    elif span.local_kv:
        srcm = xm if x_kv is None else parallel.copy_to_model(src, mesh)
        k = dense_apply(p["k"], srcm, policy, site=f"{site}/k", mesh=kv_mesh).reshape(b, t, -1, hd)
        v = dense_apply(p["v"], srcm, policy, site=f"{site}/v", mesh=kv_mesh).reshape(b, t, -1, hd)
    else:
        lo, hi = span.kv
        # whole where fit_spec dropped model from it or serving gathered it at load
        whole = p["k"]["w"].shape[-1] == cfg.n_kv_heads * hd
        k, v = (dense_apply(p[n], src, policy, site=f"{site}/{n}", mesh=kv_mesh,
                            split="rep" if whole else "gather") for n in ("k", "v"))
        if span.split:
            k, v = parallel.copy_to_model(k, mesh), parallel.copy_to_model(v, mesh)
        k, v = (y.reshape(b, t, -1, hd)[:, :, lo:hi] for y in (k, v))
    if kv_mesh is not mesh:  # the group's queries' gradients summed: the sites' dY whole
        k, v = parallel.sum_grad_over_seq(torch.stack([k, v]), seq).unbind(0)
    if rope is not None:
        q = apply_rope(q, rope)
        if x_kv is None:
            k = apply_rope(k, rope)

    if kv_cache is None:
        q0, pos = 0, {}
        if seq is not None and x_kv is None:
            lay = mesh.layout
            q0 = lay.seq[0]
            if not lay.one_run:
                pos = {"q_pos": lay.positions(x.device), "kv_pos": lay.group_positions(x.device)}
            k, v = parallel.gather_seq(torch.stack([k, v]), seq, dim=2).unbind(0)
        out = masked_attention(q, k, v, causal=causal and x_kv is None, q_chunk=cfg.attn_q_chunk,
                               q_offset=q0, **pos)
    else:
        k_pool, v_pool = kv_cache["k"], kv_cache["v"]
        rows, cols, dest = geom.write_index
        kw, vw = k, v
        if geom.gather is not None:
            m = geom.gather
            kw, vw = parallel.all_gather(torch.stack([k, v]), m.data_group, m.dp, dim=1)
        k_pool[dest] = kw[rows, cols].to(k_pool.dtype)
        v_pool[dest] = vw[rows, cols].to(v_pool.dtype)
        qpos, block_tables = geom.qpos, geom.block_tables
        if block_tables is None and geom.seq is not None:
            out = seq_split_attention(q, k_pool, v_pool, qpos, geom.seq,
                                      span.q if seq_model else None).to(q.dtype)
        elif block_tables is None:
            tables = torch.arange(b, dtype=torch.int32, device=x.device)[:, None]
            out = paged_attention_ref(q, k_pool, v_pool, tables, qpos).to(q.dtype)
        elif paged_kernel:
            out = kops.paged_attention(q, k_pool, v_pool, block_tables, qpos)
        else:
            out = paged_attention_ref(q, k_pool, v_pool, block_tables, qpos).to(q.dtype)
    out = out.reshape(b, s, -1)[..., span.cols[0]:span.cols[1]].contiguous()  # the rank's own
    return dense_apply(p["o"], out, policy, site=f"{site}/o", mesh=mesh,
                       split="row" if span.split else "rep"), kv_cache


def model_splits(width: int, mesh) -> bool:
    """Does a mesh's ``model`` axis split a dim of ``width`` (``fit_spec``
    keeps an axis on a dim it divides; where it does not, the leaf's
    ``model`` split moves elsewhere or is dropped, and every model rank
    holds the dim whole)?"""
    return mesh is not None and mesh.model > 1 and width % mesh.model == 0


def kv_whole_heads(cfg, model: int) -> bool:
    """Do a model mesh's ranks hold whole KV heads of k/v (``model``
    divides them, as ``fit_spec`` then keeps ``model`` on their columns at
    a head boundary)?"""
    return cfg.n_kv_heads % model == 0


class HeadSpan(NamedTuple):
    """The attention heads one rank of a model mesh runs
    (:func:`head_span`): q heads ``[q[0], q[1])`` and the KV heads
    ``[kv[0], kv[1])`` they read; ``cols`` the rank's own q columns
    ``[lo, hi)`` within the span's heads flattened (what its row of the
    row-parallel ``o`` reads). ``split``: ``model`` splits q's columns
    (else every rank runs every head, and q, k, v and o are held whole);
    ``gather_q``: those columns cut across heads, so q is all-gathered
    over ``model`` and the span taken; ``local_kv``: the rank's k/v
    columns are the span's KV heads (else the full k/v products are
    computed alike on every rank and the span's KV heads taken)."""

    q: tuple[int, int]
    kv: tuple[int, int]
    cols: tuple[int, int]
    split: bool = False
    gather_q: bool = False
    local_kv: bool = False


def head_span(cfg, model: int, rank: int) -> HeadSpan:
    """Rank ``rank``'s :class:`HeadSpan` on a model mesh of ``model``. The
    rank holds q columns ``[r*c, (r+1)*c)`` of ``H*hd``, ``c = H*hd /
    model`` (``fit_spec`` keeps ``model`` there where it divides them);
    its span is the q heads those columns touch, and the KV heads those
    read. ``paged_attention`` has each KV head serve the same number of
    its q heads (``row_id = kvh*G + g``), so where the span's KV heads
    would serve unequal numbers of them it widens to whole GQA groups.
    Where ``model`` does not divide ``H*hd`` the q split is dropped (a
    move elsewhere is refused, ``model.mesh_unported``): every head (and
    none in a stack without attention)."""
    h, n_kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if model == 1 or not n_kv or (h * hd) % model:
        return HeadSpan((0, h), (0, n_kv), (0, h * hd))
    c, g = h * hd // model, h // n_kv
    lo, hi = rank * c // hd, -(-(rank + 1) * c // hd)
    klo, khi = lo // g, (hi - 1) // g + 1
    if len({min(hi, (j + 1) * g) - max(lo, j * g) for j in range(klo, khi)}) > 1:
        lo, hi = klo * g, khi * g
    cols = (rank * c - lo * hd, (rank + 1) * c - lo * hd)
    return HeadSpan((lo, hi), (klo, khi), cols, True, cols != (0, (hi - lo) * hd),
                    kv_whole_heads(cfg, model))


def mesh_head_span(cfg, mesh) -> HeadSpan:
    """:func:`head_span` of ``mesh``'s rank (every head off a mesh)."""
    if mesh is None:
        return head_span(cfg, 1, 0)
    return head_span(cfg, mesh.model, mesh.model_rank)


def kv_range(cfg, mesh) -> tuple[int, int]:
    """The ``[lo, hi)`` KV heads this rank's q heads read, which its KV
    cache holds (all of them off a mesh): its :func:`head_span`'s. Where
    the model size does not divide the KV heads a head is held by every
    rank that reads it, the layout of the reference's ``replicate_kv``."""
    return mesh_head_span(cfg, mesh).kv


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------

# ``jax.nn.gelu`` defaults to the tanh approximation
_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}


def mlp_init(gen, d_model, d_ff, dtype=torch.bfloat16, gated: bool = True, device="cuda"):
    """The gated MLP ``{"up", "gate", "down"}``, or without ``gate`` the
    2-matrix one (nemotron's relu2)."""
    kw = dict(dtype=dtype, device=device)
    p = {"up": dense_init(gen, d_model, d_ff, **kw)}
    if gated:
        p["gate"] = dense_init(gen, d_model, d_ff, **kw)
    p["down"] = dense_init(gen, d_ff, d_model, **kw)
    return p


def mlp_apply(p, x, act: str, policy: PolicyLike = DENSE, site: str = "mlp", mesh=None, *,
              d_ff: int):
    """``down(act(gate(x)) * up(x))``, or ``down(act(up(x)))`` for the
    non-gated MLP (params without ``gate``); sites ``{site}/up``,
    ``{site}/gate``, ``{site}/down``. On a ``mesh`` where ``model``
    divides the hidden width ``d_ff``: this rank's ``d_ff`` columns,
    up/gate column-parallel, down row-parallel; where it does not
    (``fit_spec`` drops the split) every rank runs the whole MLP."""
    fn = _ACTS[act]
    split = model_splits(d_ff, mesh)
    col, row = ("col", "row") if split else ("rep", "rep")
    if split:
        x = parallel.copy_to_model(x, mesh)
    if "gate" in p:
        h = fn(dense_apply(p["gate"], x, policy, site=f"{site}/gate", mesh=mesh, split=col)) * (
            dense_apply(p["up"], x, policy, site=f"{site}/up", mesh=mesh, split=col))
    else:
        h = fn(dense_apply(p["up"], x, policy, site=f"{site}/up", mesh=mesh, split=col))
    return dense_apply(p["down"], h, policy, site=f"{site}/down", mesh=mesh, split=row)


# ----------------------------------------------------------------------
# embeddings
# ----------------------------------------------------------------------


def embed_init(gen, vocab, d_model, dtype=torch.bfloat16, device="cuda"):
    t = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32, device=device)
    return {"table": (t * 0.02).to(dtype)}


def embed_apply(p, tokens, mesh=None):
    """The rows of ``tokens``; on a ``mesh`` the vocab-parallel lookup."""
    if mesh is None:
        return p["table"][tokens.long()]
    return parallel.vocab_embed(p["table"], tokens, mesh)


def unembed_local(p, x, mesh) -> torch.Tensor:
    """This rank's vocabulary columns of the tied unembedding, fp32 and
    unmasked: ``x`` (replicated over ``model``, behind ``copy_to_model``)
    against the local table rows."""
    return parallel.copy_to_model(x, mesh).float() @ p["table"].float().t()


def unembed_apply(p, x, valid: int | None = None, mesh=None):
    """Tied unembedding: x [B,S,d] @ table^T -> logits in fp32.

    Both operands go to fp32 before the product, as the JAX package's
    ``preferred_element_type=float32`` accumulates: rounding 152k logits
    to bf16 would make argmax ties common. ``valid`` masks the logits of
    the padded vocabulary rows to -1e30. On a ``mesh`` every rank gets
    the full row, each rank's columns all-gathered in vocab order.
    """
    if mesh is not None:
        logits = parallel.gather_vocab(unembed_local(p, x, mesh), mesh)
        if valid is not None and valid < logits.shape[-1]:
            logits[..., valid:] = -1e30
        return logits
    table = p["table"]
    logits = x.float() @ table.float().t()
    v = table.shape[0]
    if valid is not None and valid < v:
        logits[..., valid:] = -1e30
    return logits
