"""Top-level LM: embeddings + stack + loss + the per-slot decode API.

The twin of ``repro.models.model`` for every family (dense, moe, ssm,
hybrid, encdec, vlm):

  * ``init_params(cfg, seed, device)``          -> params
  * ``params_from_jax(cfg, tree, device)``      -> params from a JAX param tree
  * ``jax_layout(cfg, params, stack)``          -> the JAX layout of params (or of an Adam
    moment tree), each stack of per-layer tensors made one leaf by ``stack``
  * ``site_names(cfg)``                         -> (sites, depth)
  * ``forward(cfg, params, batch, policy)``     -> (logits fp32, aux)
  * ``loss_fn(cfg, params, batch, policy)``     -> (loss, metrics)
  * ``kernel_launches_per_step(cfg, policy)``   -> the kernels a train step launches
  * ``mesh_specs(cfg, params, mesh_shape)``     -> each leaf's fitted spec on a mesh
  * ``init_cache(cfg, batch, max_seq, dtype, device)``   -> the contiguous cache
  * ``init_paged_cache(cfg, n_blocks, block_size, dtype, device, batch=)``
  * ``batch_layout(cfg, mesh, global_batch, seq_len)``  -> how a mesh rank holds a batch
  * ``cache_layout(cfg, mesh, n_slots, max_seq, ...)``  -> how a mesh rank holds a cache
  * ``init_local_cache(cfg, layout, mesh, ...)``          -> that rank's cache
  * ``decode_slots(cfg, params, tokens, cache, slot_pos, token_count, ...)``
  * ``decode_step(cfg, params, tokens, cache, pos)``      -> lock-step decode
  * ``encode(cfg, params, frames)``             -> the encoder's output (encdec)
  * ``encode_frames(cfg, params, frames, device)`` -> the same from numpy frames
  * ``commit_spec_cache(cache, keep)``
  * ``reset_slots(cache, free_mask)`` / ``reset_paged(cache, slot_mask, page_mask)``
  * ``swap_out_slot(cache, slot, pages)`` / ``swap_in_slot(cache, data, slot, pages)``

Batches are dicts of tensors: ``tokens [B,S]``, ``targets [B,S]`` and
optionally ``loss_mask [B,S]``; a vlm batch adds ``patches [B,
n_patches, d_model]`` (the stubbed vision frontend's output), an encdec
batch ``frames [B, enc_seq, d_model]`` (the stubbed audio frontend's).

Params are nested dicts of tensors in the JAX package's layouts, with
each stack as a list of per-layer dicts instead of stacked arrays: the
decoder-only families' ``stack``, the encdec family's ``encoder``,
``enc_norm`` and ``decoder``. A decode cache is a list of per-layer
dicts: ``{"k", "v"}`` for an attention layer (the cross-decoder's
self-attention among them; paged: a page pool; contiguous: rows a
slot), ``{"conv", "state"}`` for a Mamba layer (a row a slot either
way). The encoder's output is not cached here: the serving engine keeps
it a slot, and the cross-attention projects its K/V at every step.

On a device mesh (``mesh=``, ``launch/mesh.py::Mesh``; every family)
params are this rank's shards of the leaves (:func:`mesh_specs`,
``dist/sharding.py::shard_tree``), a batch is this rank's block of the
global batch (:func:`batch_layout`: its rows, or where the data axes do
not divide the batch its block of the sequence, or the whole batch), and
the loss, its gradients and the decode logits are the one-device model's
(``dist/parallel.py``): attention runs the q heads its columns touch
(``layers.head_span``), MLPs hold their ``d_ff`` columns, MoE layers
their experts, SSM layers their heads, a leaf ``fit_spec`` drops
``model`` from is whole on every rank (:func:`mesh_split`), and the VLM's
patch prefix and the encoder's output are replicated over ``model``.
Serving on a ``data x model`` mesh (:func:`cache_layout`): a rank holds
its slots' rows of the slot-major state (the step's tokens, contiguous
K/V, SSM rows) where the data size divides the slots, the whole paged
pool (replicated over ``data``), its KV heads, and the contiguous K/V's
slice of the sequence where the fitted spec puts a mesh axis there.
"""
from __future__ import annotations

from collections.abc import Callable
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparsity
from repro_torch.core.policy import DENSE, PolicyLike, policy_for
from repro_torch.dist import parallel
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import layers, ssm, transformer


def init_params(cfg: ModelConfig, seed: int, device="cuda") -> dict[str, Any]:
    """Random params with the JAX package's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dt = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {
        "embed": layers.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device=device),
        "final_norm": layers.rmsnorm_init(cfg.d_model, dt, device=device),
    }
    if cfg.family == "encdec":
        params["encoder"] = transformer.encoder_init(gen, cfg, device)
        params["enc_norm"] = layers.rmsnorm_init(cfg.d_model, dt, device=device)
        params["decoder"] = transformer.cross_decoder_init(gen, cfg, device)
    else:
        params["stack"] = transformer.stack_init(gen, cfg, device)
    return params


def _tensor(a, device) -> torch.Tensor:
    """A fresh tensor on ``device`` with the values of a torch tensor or a
    numpy array (a writable copy either way)."""
    if isinstance(a, torch.Tensor):
        return torch.empty(a.shape, dtype=a.dtype, device=device).copy_(a)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: widen exactly, then narrow
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(cfg: ModelConfig, tree, device="cuda") -> dict[str, Any]:
    """The port's params from a tree in the JAX package's layout whose
    leaves are numpy arrays (``jax.tree.map(np.asarray, params)``) or
    torch host tensors (a restored checkpoint's, bf16 among them); an
    Adam moment tree converts the same way. The JAX package stacks each
    period slot's leaves ``[n_periods, ...]``, so layer ``i * plen + j``
    is ``tree["stack"]["slots"][j][...][i]``; the encdec family's
    ``encoder`` and ``decoder`` leaves are stacked ``[n_layers, ...]``.
    Every leaf is copied into a fresh tensor on ``device``, a layer at a
    time."""

    def convert(node, pi=None):
        if isinstance(node, dict):
            return {k: convert(v, pi) for k, v in node.items()}
        a = node if isinstance(node, torch.Tensor) else np.asarray(node)
        return _tensor(a if pi is None else a[pi], device)

    out = {"embed": convert(tree["embed"]), "final_norm": convert(tree["final_norm"])}
    if cfg.family == "encdec":
        out["encoder"] = {"layers": [convert(tree["encoder"], i)
                                     for i in range(cfg.n_enc_layers)]}
        out["enc_norm"] = convert(tree["enc_norm"])
        out["decoder"] = {"layers": [convert(tree["decoder"], i) for i in range(cfg.n_layers)]}
        return out
    plen = len(transformer.period_pattern(cfg))
    slots = tree["stack"]["slots"]
    out["stack"] = {"layers": [convert(slots[li % plen], li // plen)
                               for li in range(cfg.n_layers)]}
    return out


def jax_layout(cfg: ModelConfig, tree, stack: Callable[[list], Any]) -> dict[str, Any]:
    """The inverse of :func:`params_from_jax`'s layout change: the port's
    params (or an Adam moment tree of the same structure) in the JAX
    package's layout and key names. Each stacked leaf is ``stack`` of the
    list of the port's per-layer tensors: ``torch.stack`` makes the
    stacked tensor; a checkpoint passes a lazy leaf that its snapshot
    stacks on the host, a layer at a time, never on the device."""

    def stacked(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stacked([layer[k] for layer in layers]) for k in first}
        return stack(layers)

    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if cfg.family == "encdec":
        out["encoder"] = stacked(tree["encoder"]["layers"])
        out["enc_norm"] = tree["enc_norm"]
        out["decoder"] = stacked(tree["decoder"]["layers"])
        return out
    plen = len(transformer.period_pattern(cfg))
    layers = tree["stack"]["layers"]
    out["stack"] = {"slots": [stacked(layers[j::plen]) for j in range(plen)]}
    return out


class StackShape:
    """A shape-only stacked leaf (for spec rules over the JAX layout)."""

    def __init__(self, parts):
        self.shape = (len(parts), *parts[0].shape)
        self.dtype = parts[0].dtype


def mesh_specs(cfg: ModelConfig, params, mesh_shape, *, replicate_kv: bool = False
               ) -> dict[str, Any]:
    """Each leaf's spec on a mesh of ``mesh_shape``, in the port's layout:
    ``dist/sharding.py``'s rules over the JAX layout (:func:`jax_layout`),
    fitted to the stacked shapes with ``fit_spec``, a per-layer tensor
    taking its stack's spec without the stack dim (every family: the
    decoder stack's period slots, the encoder's and the cross-decoder's
    layer stacks). ``replicate_kv``: the k/v kernels whole on every rank
    (seq-sharded decode, ``cfg.decode_seq_shard``)."""
    fitted = shd.param_shardings(mesh_shape, jax_layout(cfg, params, StackShape),
                                 replicate_kv=replicate_kv)

    def unstack(sp):
        if isinstance(sp, dict):
            return {k: unstack(v) for k, v in sp.items()}
        if sp[0] is not None:
            raise NotImplementedError(f"a spec {sp} that splits the layer stack")
        return shd.Spec(*sp[1:])

    out = {"embed": fitted["embed"], "final_norm": fitted["final_norm"]}
    if cfg.family == "encdec":
        out["encoder"] = {"layers": [unstack(fitted["encoder"])] * cfg.n_enc_layers}
        out["enc_norm"] = fitted["enc_norm"]
        out["decoder"] = {"layers": [unstack(fitted["decoder"])] * cfg.n_layers}
        return out
    plen = len(transformer.period_pattern(cfg))
    slots = fitted["stack"]["slots"]
    out["stack"] = {"layers": [unstack(slots[li % plen]) for li in range(cfg.n_layers)]}
    return out


def mesh_unported(cfg: ModelConfig, model: int) -> list[str]:
    """What a model mesh of ``model`` cannot split of ``cfg`` yet, each
    as the CLIs name it: experts it does not divide, and a leaf whose
    fitted spec moves ``model`` onto a dim the port's step does not split
    (no registry arch has one at the model sizes that divide 16)."""
    out = []
    if model > 1 and cfg.is_moe and cfg.n_experts % model:
        out.append(f"--model-mesh {model} that does not divide the {cfg.n_experts} experts")
    if model > 1:
        vocab = shd.fit_spec(shd.Spec("model", None), (cfg.padded_vocab, cfg.d_model),
                             {"model": model})
        if vocab[1] is not None:
            out.append(f"--model-mesh {model} that fit_spec moves off the vocabulary onto "
                       "the embedding's width")
        seen = set()
        for site in site_names(cfg)[0]:
            shape = _site_shape(cfg, site)
            if is_expert_site(site) or shape in seen:
                continue
            seen.add(shape)
            try:
                mesh_split(cfg, site, model)
            except NotImplementedError as e:
                out.append(str(e))
    return out


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class BatchLayout:
    """How one rank of a mesh holds a training batch of ``global_batch``
    rows of ``seq_len`` tokens (:func:`batch_layout`): its rows ``[lo,
    hi)`` and its block ``[s0, s1)`` of the sequence; ``batch_axes`` and
    ``seq_axes`` the data axes the reference's fitted spec puts on the
    batch and on the sequence dims (a data axis on neither: the data ranks
    hold the whole batch alike). The VLM's sequence is ``patches ++
    tokens``: ``n_patches`` and the rank's block ``patches`` ``[p0, p1)``
    of them, split over the sequence axes as its tokens are. ``whole``:
    each input the fitted spec splits over a data axis on a dim the port's
    step does not split, held whole by the rank, with the reason."""

    global_batch: int
    seq_len: int
    rows: tuple[int, int]
    seq: tuple[int, int]
    batch_axes: tuple[str, ...] = ()
    seq_axes: tuple[str, ...] = ()
    n_patches: int = 0
    patches: tuple[int, int] = (0, 0)
    whole: tuple[str, ...] = ()

    @property
    def token_axes(self) -> tuple[str, ...]:
        """The data axes that split the step's tokens (pod-major)."""
        return tuple(a for a in ("pod", "data") if a in self.batch_axes + self.seq_axes)

    @property
    def seq_split(self) -> bool:
        return self.seq != (0, self.seq_len)

    @property
    def one_run(self) -> bool:
        """Are the rank's positions one run (no patch prefix split with
        the tokens)?"""
        return not (self.n_patches and self.seq_split)

    def block(self, a):
        """This rank's block of a ``[B, S, ...]`` array or tensor."""
        return a[self.rows[0]:self.rows[1], self.seq[0]:self.seq[1]]

    def patch_block(self, a):
        """This rank's block of the VLM's ``[B, n_patches, ...]`` patches."""
        return a[self.rows[0]:self.rows[1], self.patches[0]:self.patches[1]]

    def _positions(self, j: int, device) -> torch.Tensor:
        """The global positions of the ``j``-th block of the sequence split."""
        ps, ts = self.patches[1] - self.patches[0], self.seq[1] - self.seq[0]
        toks = torch.arange(j * ts, (j + 1) * ts, device=device)
        if not self.n_patches:
            return toks
        return torch.cat([torch.arange(j * ps, (j + 1) * ps, device=device),
                          self.n_patches + toks])

    def positions(self, device) -> torch.Tensor:
        """The global positions of the rank's sequence block: its tokens'
        (``arange(s0, s1)``), or the VLM's patch block then its token
        block (``cat(arange(p0, p1), n_patches + arange(s0, s1))``)."""
        return self._positions(self.seq[0] // (self.seq[1] - self.seq[0]), device)

    def group_positions(self, device) -> torch.Tensor:
        """Every block's positions, in the rank order ``gather_seq``
        concatenates the sequence group's blocks in: the keys' positions
        of attention over the gathered K/V (static, no collective)."""
        n = self.seq_len // (self.seq[1] - self.seq[0])
        return torch.cat([self._positions(j, device) for j in range(n)])

    def token_index(self, device) -> torch.Tensor:
        """Each of the rank's tokens' index in the global batch flattened
        row-major (``row * seq_len + position``), in the rank's own
        row-major order."""
        rows = torch.arange(self.rows[0], self.rows[1], device=device)
        toks = torch.arange(self.seq[0], self.seq[1], device=device)
        return (rows[:, None] * self.seq_len + toks[None, :]).reshape(-1)

    def step_mesh(self, mesh):
        """The mesh view the step runs on: the data group narrowed to the
        axes that split the tokens (none: the model group alone), with
        this layout and the sequence split (``launch/mesh.py::Mesh.over``)."""
        if mesh is None:
            return None
        seq = None
        if self.seq_split:
            group, n, i = mesh.axis_group(self.seq_axes)
            seq = layers.SeqSplit("+".join(self.seq_axes), group, n, i)
        return mesh.over(self.token_axes, self, seq)

    def batch_mesh(self, mesh):
        """The view over the batch axes alone (no sequence split; none on
        16x16): what the encoder and the cross-attention's K/V run on,
        whose rows every rank of the sequence group holds alike."""
        return mesh.over(self.batch_axes, self, None)


_FRONTEND = {"encdec": "frames", "vlm": "patches"}  # the stubbed frontends' batch inputs


def batch_layout(cfg: ModelConfig, mesh, global_batch: int, seq_len: int) -> BatchLayout:
    """How a rank of ``mesh`` (``None``: one device) holds a training batch,
    read from the reference's fitted specs of its inputs
    (``dist/sharding.py::batch_specs``): the data axes stay on the batch
    where they divide it; where they do not, ``fit_spec`` moves an axis to
    the sequence where it divides that (on 2x16x16 at batch 8: ``pod`` on
    the batch, ``data`` on the sequence), and replicates it where it
    divides neither.

    The frontends' inputs take the tokens' rows. The VLM's patches take
    the block their fitted spec gives their patch dim, which must be split
    over the tokens' sequence axes (on the production meshes it is: 256
    patches); a spec that splits the tokens' sequence but not the patches
    is refused (ROADMAP Queue 1 item 5 sub-item 4). The encoder-decoder's
    frames stay whole past their rows (whisper's 1500 frames: ``data`` on
    ``d_model``): the encoder runs on every rank of the sequence group
    alike. Each such whole input is listed in ``whole``; where the tokens
    are replicated over a data axis, so are the patches and frames."""
    n_p = cfg.n_patches if cfg.family == "vlm" else 0
    if mesh is None:
        return BatchLayout(global_batch, seq_len, (0, global_batch), (0, seq_len),
                           n_patches=n_p, patches=(0, n_p))
    shape = (global_batch, seq_len)
    inputs = {"tokens": torch.empty(shape, device="meta")}
    front = _FRONTEND.get(cfg.family)
    if front:
        n = cfg.n_patches if front == "patches" else cfg.enc_seq
        inputs[front] = torch.empty((global_batch, n, cfg.d_model), device="meta")
    specs = shd.batch_specs(mesh.shape, inputs)
    spec = specs["tokens"]
    rows, seq = shd.local_index(spec, shape, mesh)
    seq_axes = _axes(spec[1])
    patches, whole = (0, n_p), []
    if front:
        fspec, fshape = specs[front], inputs[front].shape
        dims = ("patch" if front == "patches" else "encoder-sequence", "d_model")
        for i in (1, 2):
            axes = tuple(a for a in _axes(fspec[i]) if a in dp_axes(mesh.shape))
            if front == "patches" and i == 1 and seq_axes and axes == seq_axes:
                blk = shd.local_index(fspec, fshape, mesh)[1]
                patches = (blk.start, blk.stop)
            elif axes:
                why = ("the encoder runs on every rank of the sequence group alike"
                       if seq_axes and front == "frames" else
                       "the tokens are not split over it: every such rank steps the whole batch")
                whole.append(f"{front}: {'+'.join(axes)} on its {dims[i - 1]} dim "
                             f"({fshape[i]}), which the port's step does not split; the rank "
                             f"holds them whole ({why})")
        if front == "patches" and seq_axes and patches == (0, n_p):
            raise NotImplementedError(
                f"--global-batch {global_batch} --seq-len {seq_len} on a data mesh of "
                f"{mesh.dp} for the vlm family: the fitted spec splits the tokens' sequence "
                f"over {'+'.join(seq_axes)} but not the {n_p} patches (spec {tuple(fspec)}): a "
                "rank would hold every patch beside its block of the tokens (ROADMAP Queue 1 "
                "item 5 sub-item 4)")
    return BatchLayout(global_batch, seq_len, (rows.start or 0, rows.stop or global_batch),
                       (seq.start or 0, seq.stop or seq_len), _axes(spec[0]), seq_axes,
                       n_p, patches, tuple(whole))


def seq_alike(cfg: ModelConfig, tree):
    """A tree of bools like the params ``tree``: the leaves whose gradient
    a step that splits the sequence over a data axis computes whole and
    alike on every rank of the group. The encoder-decoder's encoder,
    ``enc_norm`` and its cross-attention's k/v kernels and biases: their
    products run on the encoder's whole rows (``transformer.encoder_apply``),
    after the K/V gradient's sum over the group (``layers.attn_apply``).
    Every other leaf's gradient is the rank's tokens' share
    (``parallel.sum_grads_over_data``)."""

    def mark(node, flag):
        if isinstance(node, dict):
            return {k: mark(v, flag) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [mark(v, flag) for v in node]
        return flag

    out = {k: mark(v, k in ("encoder", "enc_norm")) for k, v in tree.items()}
    if cfg.family == "encdec":
        for layer in out["decoder"]["layers"]:
            for n in ("k", "v"):
                layer["cross"][n] = mark(layer["cross"][n], True)
    return out


_DIM_NAMES = {  # the stacked cache leaves' dims, for the layout's report
    "kv": ("layer-stack", "slot", "sequence", "KV-head", "head"),
    "paged": ("layer-stack", "page", "within-page", "KV-head", "head"),
    "state": ("layer-stack", "slot", "head", "state", "head"),
    "conv": ("layer-stack", "slot", "window", "channel"),
}


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """How one rank of a mesh holds a decode cache of ``n_slots`` slots
    (:func:`cache_layout`): ``slots`` the ``[lo, hi)`` slot rows it
    computes and holds (every slot unless they are split over ``data``);
    ``paged`` the paged layout (a pool of pages, replicated over
    ``data``); ``seq`` the mesh axis the contiguous K/V's sequence dim is
    split over (``"model"`` or ``"data"``), or ``None``; ``whole`` the
    leaves the fitted spec splits over a data axis on a dim the port's
    step does not split, each with the reason the rank holds it whole;
    ``kv_heads`` where the fitted spec puts ``model`` on the K/V's head
    dim, which KV heads the rank holds instead, and why."""

    n_slots: int
    slots: tuple[int, int]
    paged: bool = False
    seq: str | None = None
    whole: tuple[str, ...] = ()
    kv_heads: str = ""

    @property
    def split(self) -> bool:
        """Are the slots split over ``data``?"""
        return self.slots != (0, self.n_slots)

    def rows(self, a):
        """This rank's rows of a per-slot array or tensor."""
        return a[self.slots[0]:self.slots[1]] if self.split else a

    def local_slot(self, slot: int) -> int | None:
        """``slot``'s row in this rank's slot-major leaves, or ``None``
        where another data rank holds it."""
        lo, hi = self.slots
        return slot - lo if lo <= slot < hi else None

    def owner(self, slot: int) -> int:
        """The data rank that holds ``slot``'s rows (slots split)."""
        return slot // (self.slots[1] - self.slots[0])

    def seq_split(self, mesh) -> layers.SeqSplit | None:
        if self.seq == "model":
            return layers.SeqSplit("model", mesh.model_group, mesh.model, mesh.model_rank)
        if self.seq == "data":
            return layers.SeqSplit("data", mesh.data_group, mesh.dp, mesh.data_rank)
        return None

    def row_mesh(self, mesh):
        """The mesh a step over this rank's rows runs on: ``mesh``, or
        where every data rank holds every slot its view without ``data``
        (a row's MoE dispatch then stays within the rank)."""
        if mesh is None or self.split or mesh.dp == 1:
            return mesh
        return mesh.model_only()


def jax_cache_layout(cfg: ModelConfig, cache):
    """The port's per-layer decode cache in the JAX package's layout: the
    encoder-decoder's ``{"k", "v"}`` stacked over its layers, else a tuple
    over the period's slots of each slot's layers stacked (shapes only)."""

    def stacked(leaves):
        if isinstance(leaves[0], dict):
            return {k: stacked([leaf[k] for leaf in leaves]) for k in leaves[0]}
        return StackShape(leaves)

    if cfg.family == "encdec":
        return stacked(cache)
    plen = len(transformer.period_pattern(cfg))
    return tuple(stacked(cache[j::plen]) for j in range(plen))


def _spec_leaves(tree, path=""):
    """``(path, leaf name, spec)`` of a tree of cache specs."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], f"{path}['{k}']")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, shd.Spec):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, f"{path}[{i}]")
    else:
        yield path, path.rsplit("'", 2)[-2], tree


def cache_layout(cfg: ModelConfig, mesh, n_slots: int, max_seq: int, *, paged: bool = False,
                 seq_shard: bool = False) -> CacheLayout:
    """How a rank of ``mesh`` (``None``: one device) holds a decode cache
    of ``n_slots`` slots of ``max_seq`` tokens, from the reference's
    fitted ``cache_specs`` over the JAX layout:

    * the slot-major state (the step's tokens, contiguous K/V, SSM rows)
      splits its slot dim over the data axes where ``fit_spec`` keeps them
      on the batch (the data size divides the slots); else every data
      rank holds every slot;
    * the paged pool keeps every page on every data rank (the page axis
      replicated);
    * where the spec puts a data axis (``long_500k``'s batch of 1) or,
      with ``seq_shard``, ``model`` on the contiguous K/V's sequence dim,
      that dim is split (:class:`~repro_torch.models.layers.SeqSplit`);
    * a data axis the spec moves onto any other dim (mamba2's state at
      batch 1: its layer stack) leaves that leaf whole on the rank, listed
      in ``whole`` with the reason;
    * the KV heads are the rank's q heads' (``layers.kv_range``), every
      KV head with ``seq_shard``; where the spec moves ``model`` to the
      K/V's head dim (the model size does not divide the KV heads),
      ``kv_heads`` says so; an SSM layer's heads its own
      (``ssm.local_heads``)."""
    layout = CacheLayout(n_slots, (0, n_slots), paged)
    if mesh is None:
        return layout
    shape = mesh.shape
    dpax = dp_axes(shape)
    baxis = dpax if len(dpax) > 1 else dpax[0]
    if paged:
        cache = init_paged_cache(cfg, 1, 1, device="meta", batch=n_slots)
    else:
        cache = init_cache(cfg, n_slots, max_seq, device="meta")
    specs = shd.cache_specs(shape, jax_cache_layout(cfg, cache), seq_shard=seq_shard, paged=paged)
    split = mesh.dp > 1 and shd.fit_spec(shd.Spec(baxis, None), (n_slots, 1), shape)[0] == baxis
    seq, whole, has_kv, kv_heads = None, [], False, ""
    for path, name, spec in _spec_leaves(specs):
        kind = "paged" if paged and name in ("k", "v") else "kv" if name in ("k", "v") else name
        has_kv = has_kv or kind == "kv"
        for i, e in enumerate(spec):
            if kind in ("kv", "paged") and i == 4 and e == "model" and not kv_heads:
                lo, hi = layers.kv_range(cfg, mesh)
                kv_heads = (f"{path}: the reference puts model on the head dim ({cfg.n_kv_heads} "
                            f"KV heads that model {mesh.model} does not divide); the rank holds "
                            f"whole KV heads, those its q heads read ([{lo}, {hi}) of "
                            f"{cfg.n_kv_heads}), since a split head dim needs a partial-sum "
                            "all-reduce of the scores, which paged_attention cannot do")
            if kind == "kv" and i == 2 and (e == "model" and seq_shard or
                                            e == baxis and mesh.dp > 1):
                seq = "model" if e == "model" else "data"
            elif (mesh.dp > 1 and e is not None and not (i == 1 and split)
                  and set(e if isinstance(e, tuple) else (e,)) & set(dpax)):
                whole.append(f"{path}: {e} on its {_DIM_NAMES[kind][i]} dim, which the port's "
                             "step does not split; the rank holds the leaf whole")
    if seq_shard and has_kv and seq != "model":
        raise NotImplementedError(f"seq-sharded decode at {max_seq} tokens on a model mesh of "
                                  f"{mesh.model}: the sequence dim is not split over model")
    slots = (0, n_slots)
    if split:
        per = n_slots // mesh.dp
        slots = (mesh.data_rank * per, (mesh.data_rank + 1) * per)
    return CacheLayout(n_slots, slots, paged, seq, tuple(whole), kv_heads)


def shard_cache(cfg: ModelConfig, cache, mesh, layout: CacheLayout):
    """This rank's shard of a decode cache on a mesh: an attention layer's
    K/V keep the KV heads its head span's q heads read (``layers.kv_range``: the
    reference's ``cache_specs``, ``model`` on the KV-head dim, where the
    model size divides the KV heads; else the layout of its
    ``replicate_kv``, each head on every rank that reads it, since
    ``fit_spec``'s move of ``model`` to the head dim would need a
    partial-sum all-reduce of the scores the kernel cannot do), every KV
    head under a ``model`` sequence split; an SSM layer's rows keep the
    rank's heads (``ssm.shard_cache``); and by ``layout``
    (:func:`cache_layout`) the rank's slot rows of the slot-major leaves
    and its slice of the contiguous K/V's sequence. The page axis of a
    paged pool is never split."""
    seq = layout.seq_split(mesh)
    lo, hi = (0, cfg.n_kv_heads) if seq is not None and seq.axis == "model" else \
        layers.kv_range(cfg, mesh)

    def kv(t):
        if not layout.paged:
            t = layout.rows(t)
            if seq is not None:
                n = t.shape[1] // seq.n
                t = t[:, seq.index * n:(seq.index + 1) * n]
        return t[:, :, lo:hi].contiguous()

    out = []
    for layer in cache:
        if "k" in layer:
            out.append({k: kv(t) for k, t in layer.items()})
        else:
            out.append(ssm.shard_cache(cfg, layer, mesh, rows=slice(*layout.slots)))
    return out


def init_local_cache(cfg: ModelConfig, layout: CacheLayout, mesh, *, max_seq: int = 0,
                     n_blocks: int = 0, block_size: int = 0, dtype=None, device="cuda"):
    """This rank's decode cache, zeros: contiguous (``max_seq`` tokens a
    slot) or, with ``layout.paged``, a pool of ``n_blocks`` pages of
    ``block_size`` and the sink (:func:`init_paged_cache`). The full
    cache is laid out on ``meta`` and sharded there (:func:`shard_cache`),
    so only the rank's shard is allocated."""
    if layout.paged:
        full = init_paged_cache(cfg, n_blocks, block_size, dtype, device="meta",
                                batch=layout.n_slots)
    else:
        full = init_cache(cfg, layout.n_slots, max_seq, dtype, device="meta")
    if mesh is not None:
        full = shard_cache(cfg, full, mesh, layout)
    return [{k: torch.zeros(t.shape, dtype=t.dtype, device=device) for k, t in layer.items()}
            for layer in full]


def decode_params(cfg: ModelConfig, params, mesh):
    """A model-mesh rank's serving params: its shards, with the leaves a
    step would gather on use at every layer gathered once, in place (the
    SSM's ``in_proj``, whose even column split cuts across its parts, and
    k/v where the model size does not divide the KV heads). Training
    keeps them sharded (its gradients are the shards')."""
    if mesh is None or mesh.model == 1:
        return params
    split_kv = not layers.kv_whole_heads(cfg, mesh.model)
    stacks = ("stack", "decoder", "encoder")
    for layer in [t for k in stacks if k in params for t in params[k]["layers"]]:
        leaves = [layer["ssm"]["in_proj"]] if "ssm" in layer else []
        if split_kv:  # shards only: under replicate_kv they are whole already
            leaves += [layer[r][n] for r in ("attn", "self", "cross") if r in layer
                       for n in ("k", "v")
                       if layer[r][n]["w"].shape[-1] < cfg.n_kv_heads * cfg.head_dim]
        for p in leaves:
            p["w"] = parallel.all_gather(p["w"], mesh.model_group, mesh.model, dim=-1)
    return params


def site_names(cfg: ModelConfig):
    """Every sparsifiable call site of this model and the depth negative
    layer indices in rule patterns resolve against: ``(sites, depth)``,
    the inputs of :meth:`~repro_torch.core.policy.PolicyProgram.resolve`.
    The encdec family's are the encoder's (``enc/layer_{i}/...``) and then
    the cross-decoder's."""
    if cfg.family == "encdec":
        sites = transformer.encoder_sites(cfg) + transformer.cross_decoder_sites(cfg)
    else:
        sites = transformer.stack_sites(cfg)
    return sites, cfg.n_layers


def _vocab_mesh(cfg, mesh):
    """The mesh the vocab-parallel embedding, unembedding and
    cross-entropy run on: ``mesh`` where ``model`` splits the vocabulary,
    else none (``fit_spec`` dropped the split: every rank holds the whole
    table and computes alike)."""
    return mesh if layers.model_splits(cfg.padded_vocab, mesh) else None


def _embed_inputs(cfg, params, batch, mesh=None):
    """Token embeddings, with the VLM's patch prefix in front (on a mesh
    whose step splits the sequence, the rank's patch block in front of its
    token block)."""
    x = layers.embed_apply(params["embed"], batch["tokens"], _vocab_mesh(cfg, mesh))
    if cfg.family == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def forward(cfg: ModelConfig, params, batch, policy: PolicyLike = DENSE, mesh=None):
    """Full-sequence forward. Returns (logits fp32 [B, S, V], aux loss):
    the MoE layers' load-balance losses summed (0 without MoE layers).
    On a ``mesh`` the logits are every vocabulary column, gathered.

    vlm: the patches go in front of the tokens, and their positions are
    cut off after the final norm, so a token at index i sits at position
    ``n_patches + i`` and the logits are the tokens' alone. encdec: the
    encoder runs over ``frames`` (in the params' dtype), its output
    normed, and the cross-decoder attends to it."""
    x, aux = _hidden(cfg, params, batch, policy, mesh)
    logits = layers.unembed_apply(params["embed"], x, valid=cfg.vocab,
                                  mesh=_vocab_mesh(cfg, mesh))
    return logits, aux


def _hidden(cfg, params, batch, policy, mesh):
    """The final-normed hidden states the unembedding reads, and aux."""
    x = _embed_inputs(cfg, params, batch, mesh)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "encdec":
        enc = encode(cfg, params, batch["frames"].to(x.dtype), policy, mesh=mesh)
        x, _ = transformer.cross_decoder_apply(params["decoder"], x, enc, cfg, policy, mesh=mesh)
    else:
        x, _, aux = transformer.stack_apply(params["stack"], x, cfg, policy, mesh=mesh)
    x = layers.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, cfg.n_patches if mesh is None else batch["patches"].shape[1]:]
    return x, aux


def encode(cfg: ModelConfig, params, frames: torch.Tensor, policy: PolicyLike = DENSE, *,
           mesh=None):
    """The encdec family's encoder pass: ``frames [B, enc_seq, d]`` ->
    the normed encoder output the cross-decoder attends to (serving runs
    it once a request, at admission). On a ``mesh`` the output is
    replicated over ``model``; where the step splits the sequence, over
    the sequence group too (``transformer.encoder_apply``)."""
    enc = transformer.encoder_apply(params["encoder"], frames, cfg, policy, mesh=mesh)
    return layers.rmsnorm_apply(params["enc_norm"], enc, cfg.norm_eps)


def encode_frames(cfg: ModelConfig, params, frames: np.ndarray, device, *,
                  mesh=None) -> torch.Tensor:
    """:func:`encode` of numpy ``frames [B, enc_seq, d]`` (a request's, as
    the workload draws them): on ``device`` in ``cfg.dtype``, no grad."""
    x = torch.from_numpy(np.asarray(frames, np.float32)).to(device)
    with torch.no_grad():
        return encode(cfg, params, x.to(getattr(torch, cfg.dtype)), mesh=mesh)


def loss_fn(cfg: ModelConfig, params, batch, policy: PolicyLike = DENSE, mesh=None):
    """Next-token cross-entropy (+0.01 aux), averaged over ``loss_mask``
    (default: every token). Returns ``(total, {"ce", "aux"})``.

    On a ``mesh`` (``batch`` this rank's block of the global batch, the
    mesh the step's view of it, ``BatchLayout.step_mesh``): the
    cross-entropy is the vocab-parallel one over the rank's logit columns,
    and the masked mean's numerator and denominator are summed over the
    view's data group before the division, so every rank's loss is the
    global one and its gradients are its tokens' share of the global
    gradient (summed over that group by the step)."""
    if mesh is not None:
        x, aux = _hidden(cfg, params, batch, policy, mesh)
        vmesh = _vocab_mesh(cfg, mesh)
        logits = layers.unembed_local(params["embed"], x, vmesh)
        nll = parallel.vocab_cross_entropy(logits, batch["targets"], cfg.vocab, vmesh)
        mask = batch.get("loss_mask")
        mask = torch.ones_like(nll) if mask is None else mask.float()
        num = parallel.sum_over_data((nll * mask).sum(), mesh)
        den = parallel.sum_over_data(mask.sum(), mesh)
        loss = num / torch.clamp(den, min=1.0)
        return loss + 0.01 * aux, {"ce": loss, "aux": aux}
    logits, aux = forward(cfg, params, batch, policy)
    targets = batch["targets"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.float()
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + 0.01 * aux, {"ce": loss, "aux": aux}


_EXPERT_SITES = ("moe/gate", "moe/up", "moe/down")  # a launch a product an expert


def _proj(site: str) -> str:
    """A site's product name: the last path part, a routed expert's
    ``[e]`` (``moe.expert_site``) cut off."""
    return site.rsplit("/", 1)[1].split("[", 1)[0]


def is_expert_site(site: str) -> bool:
    """Is ``site`` a routed expert's product (``layer_{i}/moe/gate`` and
    the like, with or without an expert's ``[e]``)?"""
    return site.split("[", 1)[0].split("/", 1)[-1] in _EXPERT_SITES


_ROW_PROJ = ("o", "down", "out_proj")  # row-parallel products (``model`` on their rows)


def site_out_dim(cfg: ModelConfig, site: str) -> int:
    """The output width (``D_out``, the selected axis) of a site's product."""
    proj = _proj(site)
    if proj == "q":
        return cfg.n_heads * cfg.head_dim
    if proj in ("k", "v"):
        return cfg.n_kv_heads * cfg.head_dim
    if proj in _ROW_PROJ:
        return cfg.d_model
    if proj == "in_proj":
        return ssm.site_cols(cfg)
    return cfg.d_ff * (cfg.n_shared_experts if "/shared/" in site else 1)  # up, gate


def _site_shape(cfg: ModelConfig, site: str) -> tuple[int, int, int, bool]:
    """A site's kernel in the JAX layout, ``[stack, d_in, d_out]``, and
    whether it is row-parallel."""
    proj = _proj(site)
    if cfg.family == "encdec":
        stack = cfg.n_enc_layers if site.startswith("enc/") else cfg.n_layers
    else:
        stack = transformer.n_periods(cfg)
    d_in = cfg.d_model
    if proj == "o":
        d_in = cfg.n_heads * cfg.head_dim
    elif proj == "out_proj":
        d_in = cfg.d_inner
    elif proj == "down":
        d_in = cfg.d_ff * (cfg.n_shared_experts if "/shared/" in site else 1)
    return stack, d_in, site_out_dim(cfg, site), proj in _ROW_PROJ


def mesh_split(cfg: ModelConfig, site: str, model: int) -> str:
    """How a rank of a model mesh of ``model`` holds a site, read from
    its kernel's fitted spec (the rule table's ``model`` on the columns,
    or on the rows of o/down/out_proj, through ``fit_spec``): ``"col"``
    (q/k/v/up/gate: its output columns; q's may cut across heads,
    ``layers.head_span``), ``"row"`` (o/down/out_proj: its input rows),
    ``"gather"`` (k/v where the model size does not divide the KV heads,
    and the SSM's in_proj, whose even column split cuts across its parts:
    the full product on every rank), or ``"rep"`` (``fit_spec`` dropped
    ``model``: the whole leaf on every rank, as a routed expert is held
    whole by one rank). A spec that moves ``model`` onto another dim
    raises."""
    proj = _proj(site)
    if model == 1 or is_expert_site(site):
        return "rep"
    *shape, row = _site_shape(cfg, site)
    spec = shd.fit_spec(shd.Spec(None, "model", None) if row else shd.Spec(None, None, "model"),
                        shape, {"model": model})
    if not shd.is_split(spec):
        return "rep"
    if spec[1 if row else 2] != "model":
        raise NotImplementedError(f"--model-mesh {model} that fit_spec moves off the "
                                  f"{'rows' if row else 'columns'} of {proj} {shape}")
    if row:
        return "row"
    if proj == "in_proj" or (proj in ("k", "v") and not layers.kv_whole_heads(cfg, model)):
        return "gather"
    return "col"


def kernel_launches_per_step(cfg: ModelConfig, policy: PolicyLike, *, model: int = 1,
                             data: int = 1, tokens: int = 0, idle_sites=(),
                             seq_split: bool = False) -> dict[str, int]:
    """Launches of each backward kernel in one training step under
    ``policy`` (a plain policy or a step's table), site by site by the
    engine's rules: a sparse site on the kernel route (``use_pallas``,
    not ``mask_mode``) launches one dX product if ``sparsify_dx`` and one
    dW product if ``sparsify_dw``, through ``matmul`` at channel
    granularity and ``dx_gathered`` / ``dw_gathered`` at block
    granularity. Every site's input needs a gradient (the embedding
    table and the norms' scales train), so layer 0 launches its dX
    products too, the encoder's first layer among them. The routed
    experts' sites (``moe/gate``, ``moe/up``, ``moe/down``) launch their
    products once an expert, and with ``moe_dp_groups`` = G once a
    (group, expert) pair (where the step's ``tokens``, every data rank's,
    split into the G groups; else, or with ``tokens`` 0, as if they do).
    A site whose ``tp_shards`` divides its output width, both sides
    sparsified, takes the TP fast path and launches nothing.

    On a ``data x model`` mesh the table is one rank's (``data`` the
    ranks that split the step's tokens, ``batch_layout``): its ``E/model``
    experts, each once a local group (``G/data`` of them, or the one
    group of the global dispatch; with ``seq_split``, every rank's tokens
    a block of the sequence, each once in each of the ``G`` groups, which
    may span ranks); the encoder's and the cross k/v's products, whose
    rows every rank of a sequence split holds whole, once on each rank; a
    column-parallel site (:func:`mesh_split`) whose ``tp_shards`` is ``t * model`` selects
    over its ``t`` local shards (the fast path when ``t > 1``, the kernel
    route when ``t == 1``); any other column-parallel site takes the
    one-device selection's channels in its columns, on the block kernels
    where its columns are whole blocks, else through ``matmul``; and
    launches nothing where that is no channel (``idle_sites``, as the
    step found them)."""
    n = {"matmul": 0, "dx_gathered": 0, "dw_gathered": 0}
    groups = cfg.moe_dp_groups
    if groups and tokens and tokens % groups:
        groups = 0
    experts = cfg.n_experts // model * max(1, groups // (1 if seq_split else data))
    for site in site_names(cfg)[0]:
        p = policy_for(policy, site)
        if not (p.active and p.use_pallas and not p.mask_mode):
            continue
        c = site_out_dim(cfg, site)
        shards, blocks = sparsity.selection_shards(p, c), True
        if mesh_split(cfg, site, model) == "col":
            if site in idle_sites:
                continue
            tp = p.tp_shards
            shards = tp // model if tp > 1 and c % tp == 0 and tp % model == 0 else 1
            blocks = (c // model) % p.block_size == 0
        if p.sparsify_dx and p.sparsify_dw and shards > 1:
            continue
        per = experts if is_expert_site(site) else 1
        if p.granularity == "channel" or not blocks:
            n["matmul"] += per * (p.sparsify_dx + p.sparsify_dw)
        else:
            n["dx_gathered"] += per * p.sparsify_dx
            n["dw_gathered"] += per * p.sparsify_dw
    return n


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None, device="cuda"):
    """Contiguous decode cache: per attention layer K/V rows ``[batch,
    max_seq, KV, hd]``, one row set per slot; per SSM layer its conv
    window and state, a row per slot."""
    dt = dtype or getattr(torch, cfg.dtype)
    return transformer.stack_cache_init(cfg, batch, max_seq, dt, device=device)


def init_paged_cache(
    cfg: ModelConfig, n_blocks: int, block_size: int, dtype=None, device="cuda", *, batch: int = 0
):
    """Paged decode cache: per attention layer a K/V page pool
    ``[n_blocks + 1, block_size, KV, hd]``, the ``n_blocks`` pages a block
    table may name and after them the sink, where a step writes its
    invalid tokens (``layers.paged_write_index``; the JAX package's pool,
    which drops them, is the first ``n_blocks``); per SSM layer its conv
    window and state for ``batch`` slots (the JAX package's first
    argument, here a keyword: a stack without SSM layers keeps no
    per-slot state)."""
    dt = dtype or getattr(torch, cfg.dtype)
    if batch < 1 and any(s.mixer == "ssm" for s in transformer.period_pattern(cfg)):
        raise ValueError(f"{cfg.name}: a paged cache of SSM layers needs the slot count (batch=)")
    return transformer.stack_cache_init(cfg, batch, block_size, dt, n_pages=n_blocks + 1,
                                        device=device)


def decode_slots(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,  # [B, C] — up to C tokens per slot this step
    cache,
    slot_pos: torch.Tensor,  # [B]: per-slot cache write position
    token_count: torch.Tensor,  # [B]: real tokens per slot (0 = idle slot)
    *,
    enc_out: torch.Tensor | None = None,  # [B, enc_seq, d] (encdec)
    block_tables: torch.Tensor | None = None,  # [B, NB] int32 (paged cache)
    paged_kernel: bool = True,
    all_logits: bool = False,
    spec_states: bool = False,
    mesh=None,
    layout: CacheLayout | None = None,
):
    """Mixed prefill/decode step over independently positioned slots.

    Every batch row is a slot with its own write position: decode slots
    feed 1 token, prefilling slots a chunk of up to C prompt tokens, idle
    slots 0. Slot b's token c is written at position ``slot_pos[b] + c``
    (invalid tokens dropped), in place; attention is causally masked per
    slot, which also fences whatever a previous occupant or a rejected
    draft left past the slot's position.

    With ``block_tables`` the cache is the paged one
    (:func:`init_paged_cache`): position p of slot b lives in page
    ``block_tables[b, p // block_size]`` at offset ``p % block_size``.
    ``paged_kernel`` (default) attends through the paged-attention
    kernel, ``paged_kernel=False`` gathers the pages. Without
    ``block_tables`` the cache is the contiguous one (:func:`init_cache`)
    and attention is plain PyTorch, as the JAX package's is there.
    The paged step writes the invalid tokens' K/V to the pools' sink page
    (:func:`init_paged_cache`), so its shapes do not depend on
    ``token_count`` (:func:`~repro_torch.models.layers.paged_write_index`).

    Returns ``(logits [B, V] fp32 at each slot's last real token,
    cache)``; ``all_logits=True`` returns the whole chunk's ``[B, C, V]``
    (the speculative verifier compares every position). Rows with
    ``token_count == 0`` carry garbage logits the caller must ignore.
    ``spec_states=True`` makes each SSM layer's cache entry the
    per-position stacks (``conv [B, C, ...]`` / ``state [B, C, ...]``),
    so that :func:`commit_spec_cache` can select the state as of an
    accepted prefix; K/V are position-addressed and unchanged.

    encdec: ``enc_out`` is each slot's encoder output (:func:`encode`),
    which every layer's cross-attention reads. vlm: the tokens alone, at
    the positions they are given; no patch prefix is fed, as in the JAX
    package's decode.

    ``mesh``: ``params`` and the cache are this rank's shards (its heads
    and KV heads, experts, SSM heads; ``enc_out`` is replicated over
    ``model``), and the logits are every vocabulary column, all-gathered,
    the same on every model rank. ``layout`` (:func:`cache_layout`; a
    ``data x model`` mesh): ``tokens``, ``slot_pos``, ``token_count``,
    ``block_tables`` and ``enc_out`` are every slot's, the same on every
    rank, and the rank computes its ``layout.slots`` rows of them; the
    logits are those rows'. Where the slots are split the paged pool
    stays the same on every data rank: the full batch's write index is
    made here and each layer all-gathers the data ranks' new K/V rows.
    """
    b, c = tokens.shape
    ar = torch.arange(c, device=tokens.device)
    positions = slot_pos.long()[:, None] + ar[None, :]  # [B, C]
    valid = ar[None, :] < token_count.long()[:, None]  # [B, C]
    place = None
    if layout is not None and mesh is not None:
        gather, write_index = None, None
        kv = transformer.kv_layers(cache)
        if block_tables is not None and layout.split and kv:
            gather = mesh
            write_index = layers.paged_write_index(block_tables, positions, valid,
                                                   cache[kv[0]]["k"].shape[1],
                                                   transformer.sink_page(cache))
        place = layers.KvPlace(write_index, gather, layout.seq_split(mesh))
        if layout.split:
            tokens, positions, valid, token_count = (layout.rows(t) for t in
                                                     (tokens, positions, valid, token_count))
            if block_tables is not None:
                block_tables = layout.rows(block_tables)
            if enc_out is not None and enc_out.shape[0] == b:
                enc_out = layout.rows(enc_out)
        mesh = layout.row_mesh(mesh)
    return _decode_rows(cfg, params, tokens, cache, positions, valid, token_count,
                        enc_out=enc_out, block_tables=block_tables, paged_kernel=paged_kernel,
                        all_logits=all_logits, spec_states=spec_states, mesh=mesh, place=place)


def _decode_rows(cfg, params, tokens, cache, positions, valid, token_count, *, enc_out,
                 block_tables, paged_kernel, all_logits, spec_states, mesh, place):
    """:func:`decode_slots` over the rows given (their positions, valid
    tokens and counts), the K/V placed by ``place``."""
    b, c = tokens.shape
    vmesh = _vocab_mesh(cfg, mesh)
    x = layers.embed_apply(params["embed"], tokens, vmesh)
    if cfg.family == "encdec":
        if enc_out is None:
            raise ValueError(f"{cfg.name}: an encdec decode step needs enc_out")
        x, cache = transformer.cross_decoder_apply(
            params["decoder"], x, enc_out, cfg,
            positions=positions, caches=cache, token_valid=valid, block_tables=block_tables,
            paged_kernel=paged_kernel, mesh=mesh, place=place,
        )
    else:
        x, cache, _ = transformer.stack_apply(
            params["stack"], x, cfg,
            positions=positions, caches=cache, token_valid=valid, block_tables=block_tables,
            paged_kernel=paged_kernel, spec_states=spec_states, mesh=mesh, place=place,
        )
    x = layers.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if all_logits:
        return layers.unembed_apply(params["embed"], x, valid=cfg.vocab, mesh=vmesh), cache
    last = torch.clamp(token_count.long() - 1, 0, c - 1)
    x_last = x[torch.arange(b, device=x.device), last][:, None]  # [B, 1, d]
    logits = layers.unembed_apply(params["embed"], x_last, valid=cfg.vocab, mesh=vmesh)[:, 0]
    return logits, cache


def decode_step(cfg: ModelConfig, params, tokens: torch.Tensor, cache, pos: int, *,
                enc_out: torch.Tensor | None = None, mesh=None,
                layout: CacheLayout | None = None):
    """One lock-step decode step over the contiguous cache: every row
    writes its ``S`` tokens at ``pos .. pos + S - 1``. The uniform-position
    case of :func:`decode_slots` (the JAX package writes it with one
    ``dynamic_update_slice``; the rows and the mask are the same).
    ``enc_out``: the rows' encoder outputs (encdec).
    Returns (logits [B, V] at the last position, cache).

    On a mesh (``layout`` from :func:`cache_layout`), ``tokens`` and
    ``enc_out`` are this rank's rows (``layout.slots``) and the cache its
    shard; with ``layout.seq`` the rank holds a slice of the sequence, and
    the step writes the new token only on the rank that holds its
    position."""
    b, s = tokens.shape
    kv = transformer.kv_layers(cache)
    seq = layout.seq_split(mesh) if layout is not None and mesh is not None else None
    t = cache[kv[0]]["k"].shape[1] * (seq.n if seq is not None else 1) if kv else pos + s
    if pos + s > t:
        raise ValueError(f"decode_step writes positions {pos}..{pos + s - 1} past max_seq {t}")
    dev = tokens.device
    positions = pos + torch.arange(s, device=dev)[None, :].expand(b, s)
    count = torch.full((b,), s, dtype=torch.int32, device=dev)
    valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    if layout is not None and mesh is not None:
        place, mesh = layers.KvPlace(seq=seq), layout.row_mesh(mesh)
    else:
        place = None
    return _decode_rows(cfg, params, tokens, cache, positions, valid, count, enc_out=enc_out,
                        block_tables=None, paged_kernel=True, all_logits=False,
                        spec_states=False, mesh=mesh, place=place)


def commit_spec_cache(cache, keep: torch.Tensor):
    """Collapse a ``spec_states=True`` cache to the accepted prefix, in
    the list: ``keep [B]`` is how many of the chunk's tokens each slot
    consumed. An SSM layer's stacks ``[B, C, ...]`` become the state at
    position ``clip(keep - 1, 0)`` (a slot with ``keep == 0`` reads
    position 0, which equals the pre-step state since invalid positions
    are frozen). K/V are position-addressed (rejected writes lie past the
    committed position, fenced by the causal mask until overwritten) and
    pass through."""
    idx = torch.clamp(keep.long() - 1, min=0)
    rows = torch.arange(idx.shape[0], device=idx.device)
    for li, layer in enumerate(cache):
        if "state" in layer:
            cache[li] = {k: t[rows, idx.to(t.device)] for k, t in layer.items()}
    return cache


def _indices(mask, device) -> torch.Tensor:
    """The set entries of a host bool mask, as a long tensor on ``device``."""
    return torch.as_tensor(np.flatnonzero(np.asarray(mask)), dtype=torch.long, device=device)


def _zero_rows(cache, mask, leaves) -> None:
    """Zero, in place, the rows in the host bool ``mask`` of every
    layer's ``leaves`` (the leading axis: slots or pages)."""
    held = [(layer, [k for k in leaves if k in layer]) for layer in cache]
    held = [(layer, names) for layer, names in held if names]
    if not held:
        return
    idx = _indices(mask, held[0][0][held[0][1][0]].device)
    if not len(idx):
        return
    for layer, names in held:
        for k in names:
            layer[k][idx] = 0


def reset_slots(cache, free_mask) -> None:
    """Zero the contiguous cache rows of the slots in ``free_mask [B]``
    (a host bool array), in place, at every layer: K/V rows and SSM
    states (which carry no position to mask by)."""
    _zero_rows(cache, free_mask, ("k", "v", "conv", "state"))


def reset_paged(cache, slot_mask, page_mask) -> None:
    """Zero freed state in a paged cache, in place: the K/V pages in
    ``page_mask [n_blocks + 1]`` and the SSM rows of the slots in ``slot_mask
    [B]``, at every layer."""
    _zero_rows(cache, page_mask, ("k", "v"))
    _zero_rows(cache, slot_mask, ("conv", "state"))


def swap_out_slot(cache, slot: int, pages, *, layout: CacheLayout | None = None, mesh=None):
    """One slot's swappable state of a paged cache, per layer: the K/V of
    its ``pages`` (``[n_pages, bs, KV, hd]`` copies) or its SSM row
    (``conv`` / ``state`` copies), on the cache's device. The bundle plus
    the slot's position restores the request's device state exactly.
    Where ``layout`` splits the slots over ``data``, the owner's SSM rows
    reach every data rank (:func:`~repro_torch.dist.parallel.from_data_rank`),
    so the bundle is the same on each and can come back into a slot any
    of them holds; the pool's pages are the same on every data rank."""
    split = layout is not None and layout.split
    row = layout.local_slot(slot) if split else slot
    out = []
    for layer in cache:
        if "k" in layer:
            idx = torch.as_tensor(np.asarray(pages), dtype=torch.long, device=layer["k"].device)
            out.append({k: layer[k].index_select(0, idx) for k in ("k", "v")})
        elif split:
            out.append({k: parallel.from_data_rank(
                t[row].clone() if row is not None else torch.zeros_like(t[0]), mesh,
                layout.owner(slot)) for k, t in layer.items()})
        else:
            out.append({k: t[slot].clone() for k, t in layer.items()})
    return out


def swap_in_slot(cache, data, slot: int, pages, *, layout: CacheLayout | None = None) -> None:
    """Write a :func:`swap_out_slot` bundle back into a paged cache, in
    place: K/V at the freshly allocated ``pages`` (the ids may differ from
    swap-out time: page contents are position-addressed within a page),
    SSM rows at ``slot``, on the data rank that holds it (``layout``)."""
    row = layout.local_slot(slot) if layout is not None and layout.split else slot
    for layer, saved in zip(cache, data, strict=True):
        where = row
        if "k" in layer:
            where = torch.as_tensor(np.asarray(pages), dtype=torch.long, device=layer["k"].device)
        elif row is None:
            continue
        for k, t in layer.items():
            t[where] = saved[k].to(device=t.device, dtype=t.dtype)


def ssm_snapshot(cache):
    """Copies of the SSM layers' states (``{layer: {"conv", "state"}}``):
    what a proposal round must restore, since K/V rows past a position
    are fenced by the mask but a recurrent state is not."""
    return {li: {k: t.clone() for k, t in layer.items()}
            for li, layer in enumerate(cache) if "state" in layer}


def ssm_restore(cache, snap) -> None:
    """Put an :func:`ssm_snapshot` back into ``cache``."""
    for li, layer in snap.items():
        cache[li] = layer
