"""The dry run of every architecture x input-shape x mesh cell (twin of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step against the
16x16 (256-chip) or 2x16x16 (512-chip) mesh on placeholder devices. The
port is one process a rank, so this process plays rank ``r`` (default 0)
of that mesh over ``torch.distributed``'s ``fake`` backend
(``launch/mesh.py::make_production_mesh``) and runs the port's own step
at full width on ``meta`` tensors under the census
(``analysis/dispatch_walk.py``): nothing is allocated, nothing runs on a
device, and the collectives return at once. For each cell it records:

  * the placements: each input's partition spec over the JAX package's
    layout (the params as a spec histogram, the other inputs leaf by
    leaf), equal to the reference's ``--placements-only`` report;
  * the per-rank argument bytes: params, Adam state and batch shards,
    from the specs (a train cell's batch as the port's rank holds it where
    it holds an input whole, ``batch_reference`` the spec's beside it); a
    decode cell's state (tokens, cache, encoder output)
    as the port's rank holds it (``models/model.py::cache_layout``), with
    the reference's spec's bytes beside it where they differ, and the
    cache leaves the rank holds whole (``cache_whole``, with why);
  * for a cell the port's CLIs run: the eager peak live bytes, the FLOPs
    a rank (torch-op contractions and the kernels' tiles), the kernel
    launches a rank by kernel, the host syncs, and the collectives' calls
    and bytes by kind, every call counted as it runs (no loop multiplier
    to apply: eager PyTorch runs each call); of them the sequence split's
    and its cross-attention K/V gradient sums (``seq_split``).

A cell that the port's CLIs refuse (ROADMAP Queue 1 item 5; none on
the production meshes since the encoder-decoder and the VLM train under
a global batch the data axes do not divide) has status ``unsupported``
with the CLI's own message; its placements and bytes are still
reported. A model mesh that cuts q's columns across heads runs each
rank's head span
(``models/layers.py::head_span``), its decode cache the span's whole KV
heads (``kv_heads`` beside the layout). A
train cell whose global batch the data axes do not divide
(``train_tight``: a batch of 8 on 16 or 2x16 data ranks) steps the rank's
block of the fitted batch spec (``models/model.py::batch_layout``:
``data`` on the sequence, ``pod`` on the batch), recorded as
``batch_block``: whisper's frames whole past their rows (``whole``, the
encoder alike on the sequence group, the cross-attention's K/V gradient
summed over it), paligemma's patch block beside its token block
(``patches``). A cell a full-attention arch
cannot take (``long_500k``) is ``skipped``. A decode cell steps the
lock-step engine's ``make_serve_step`` on the rank's cache shard (the
sequence split over ``model`` under ``--policy opt``'s seq-sharded
decode, over ``data`` where the batch of 1 cannot take it).

Usage::

  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh single --placements-only
  python -m repro_torch.launch.dryrun --all --mesh multi --policy opt --out build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.policy import DENSE, PolicyProgram, tpu_default
from repro_torch.data.pipeline import input_specs, rank_block
from repro_torch.dist import parallel
from repro_torch.dist import sharding as shd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import dp_size, production_mesh_shape, shape_mesh
from repro_torch.models import model as lm
from repro_torch.optim import adam

POLICIES = ("ssprop", "ssprop_tp", "opt", "dense")


def resolve(arch: str, policy_name: str, mesh_shape: dict[str, int]):
    """``(cfg, site table)`` of one cell: the reference's four policies
    (``opt`` also turns on the DP-local MoE dispatch and the seq-sharded
    decode), the one-rule program resolved over the arch's sites."""
    cfg = get_config(arch)
    model = mesh_shape["model"]
    if policy_name == "ssprop":
        policy = tpu_default(0.8)
    elif policy_name == "ssprop_tp":
        policy = dataclasses.replace(tpu_default(0.8), tp_shards=model)
    elif policy_name == "opt":
        policy = dataclasses.replace(tpu_default(0.8), tp_shards=model, bwd_dtype="bfloat16")
        cfg = dataclasses.replace(cfg, moe_dp_groups=dp_size(mesh_shape), decode_seq_shard=True)
    elif policy_name == "dense":
        policy = DENSE
    else:
        raise ValueError(policy_name)
    sites, depth = lm.site_names(cfg)
    return cfg, PolicyProgram.single(policy).resolve(sites, depth=depth).peak()


# ----------------------------------------------------------------------
# placements, in the JAX package's layout
# ----------------------------------------------------------------------


class _Shape:
    """A shape-only leaf."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype


def _paths(tree, prefix=""):
    """``(keystr, leaf)`` pairs as ``jax.tree_util.keystr`` names them:
    ``['key']`` a dict entry, ``[i]`` a list or tuple item, ``.field`` an
    ``AdamState`` field."""
    if isinstance(tree, shd.Spec):
        yield prefix, tree
    elif isinstance(tree, adam.AdamState):
        for f in tree._fields:
            yield from _paths(getattr(tree, f), f"{prefix}.{f}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}['{k}']")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def spec_str(spec) -> str:
    """A spec as the tuple of its entries (a JAX ``PartitionSpec``'s
    ``str`` less its ``PartitionSpec`` prefix)."""
    return repr(tuple(spec))


def shard_bytes(leaf, spec, mesh_shape) -> int:
    """Bytes of one rank's shard of ``leaf`` under the fitted ``spec``."""
    n = 1
    for i, d in enumerate(leaf.shape):
        e = spec[i] if i < len(spec) else None
        div = 1
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            div *= mesh_shape[a]
        n *= d // div
    return n * torch.empty((), dtype=leaf.dtype).element_size()


@dataclasses.dataclass
class Cell:
    """One cell's inputs in the JAX layout with their fitted specs, and
    what the port's step needs to run it."""

    cfg: object
    shape: object
    table: object
    trees: dict  # name -> (tree of shape leaves, tree of specs)
    meta: dict


def build_cell(arch: str, shape_name: str, mesh_shape: dict[str, int], policy_name: str):
    """The cell's config, policy table, input trees and their specs, or
    ``None`` and the reason for a cell the arch cannot take."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cfg.supports_shape(shape)
    if not ok:
        return None, why
    cfg, table = resolve(arch, policy_name, mesh_shape)
    cell = make_cell(cfg, shape, table, mesh_shape, opt=(policy_name == "opt"))
    cell.meta.update(arch=arch, shape=shape_name, policy=policy_name)
    return cell, ""


@functools.lru_cache(maxsize=32)
def _jax_params(cfg):
    """The params' shapes in the JAX layout (read-only, shared by cells)."""
    params, _ = steps_lib.abstract_state(cfg)
    return lm.jax_layout(cfg, params, lm.StackShape)


def make_cell(cfg, shape, table, mesh_shape: dict[str, int], *, opt: bool = False) -> Cell:
    """A cell of any config, shape and site table on a mesh of
    ``mesh_shape``; ``opt``: the ``opt`` policy's replicated k/v and
    seq-sharded caches."""
    dp = dp_size(mesh_shape)
    jl = _jax_params(cfg)
    p_specs = shd.param_shardings(mesh_shape, jl, replicate_kv=opt)
    trees = {"params": (jl, p_specs)}
    meta = {"params": cfg.param_count(), "active_params": cfg.active_param_count()}
    baxis = shd._batch_axis(mesh_shape)
    if shape.kind == "train":
        meta["accum"] = steps_lib.microbatch_plan(cfg, shape, dp)
        if shape.global_batch % dp:
            layout = lm.batch_layout(cfg, shape_mesh(mesh_shape), shape.global_batch,
                                     shape.seq_len)
            meta["batch_block"] = {"rows": list(layout.rows), "seq": list(layout.seq),
                                   "batch_axes": list(layout.batch_axes),
                                   "seq_axes": list(layout.seq_axes)}
            if layout.n_patches:
                meta["batch_block"]["patches"] = list(layout.patches)
            if layout.whole:
                meta["batch_block"]["whole"] = list(layout.whole)
        o_specs = shd.opt_state_shardings(mesh_shape, jl)
        m = adam.tree_map(lambda x: _Shape(x.shape, torch.float32), jl)  # the moments: fp32
        trees["adam"] = (adam.AdamState(_Shape((), torch.int32), m, m),
                         adam.AdamState(shd.replicated(), o_specs, o_specs))
    if shape.kind in ("train", "prefill"):
        batch = input_specs(cfg, shape)
        trees["batch"] = (batch, shd.batch_specs(mesh_shape, batch))
    else:
        b = shape.global_batch
        cache = lm.jax_cache_layout(cfg, steps_lib.abstract_cache(cfg, b, shape.seq_len))
        state = {"tokens": _Shape((b, 1), torch.int32), "pos": _Shape((), torch.int32),
                 "cache": cache}
        specs = {"tokens": shd.fit_spec(shd.Spec(baxis, None), (b, 1), mesh_shape),
                 "pos": shd.replicated(),
                 "cache": shd.cache_specs(mesh_shape, cache, seq_shard=opt)}
        if cfg.family == "encdec":
            state["enc_out"] = _Shape((b, cfg.enc_seq, cfg.d_model), getattr(torch, cfg.dtype))
            specs["enc_out"] = shd.Spec(baxis, None, None)
        trees["state"] = (state, specs)
        layout = lm.cache_layout(cfg, shape_mesh(mesh_shape), b, shape.seq_len,
                                 seq_shard=cfg.decode_seq_shard)
        meta["cache_layout"] = {"slots": list(layout.slots), "seq": layout.seq}
        if layout.whole:
            meta["cache_whole"] = list(layout.whole)
        if layout.kv_heads:
            meta["cache_kv_heads"] = layout.kv_heads
    return Cell(cfg, shape, table, trees, meta)


def _decode_state(cell: Cell, mesh, device="meta"):
    """A decode cell's step state as ``mesh``'s rank holds it (empty
    tensors on ``device``) and its cache layout: its rows of the tokens
    and the encoder output, its cache shard; ``pos`` a host int."""
    cfg, shape = cell.cfg, cell.shape
    layout = lm.cache_layout(cfg, mesh, shape.global_batch, shape.seq_len,
                             seq_shard=cfg.decode_seq_shard)
    rows = layout.slots[1] - layout.slots[0]
    cache = lm.init_local_cache(cfg, layout, mesh, max_seq=shape.seq_len, device=device)
    state = {"tokens": torch.empty((rows, 1), dtype=torch.int32, device=device), "pos": 0,
             "cache": cache}
    if cfg.family == "encdec":
        state["enc_out"] = torch.empty((rows, cfg.enc_seq, cfg.d_model),
                                       dtype=getattr(torch, cfg.dtype), device=device)
    return state, layout


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in adam.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def placement_report(cell: Cell) -> dict:
    """The params' spec -> leaf-count histogram and every other input's
    spec by path (the reference's ``_placement_report``)."""
    hist: dict[str, int] = {}
    leaves, specs = cell.trees["params"]
    for (_, sp) in _paths(specs):
        hist[spec_str(sp)] = hist.get(spec_str(sp), 0) + 1
    del leaves
    inputs = {}
    for name in ("adam", "batch", "state"):
        if name in cell.trees:
            for path, sp in _paths(cell.trees[name][1]):
                inputs[path] = spec_str(sp)
    return {"param_spec_histogram": hist, "inputs": inputs}


def rank_bytes(cell: Cell, mesh_shape) -> dict[str, int]:
    """One rank's argument bytes by input (its shards' sizes)."""
    out = {}
    for name, (tree, specs) in cell.trees.items():
        leaves = dict(_paths(tree))
        out[name] = sum(shard_bytes(leaves[p], sp, mesh_shape) for p, sp in _paths(specs))
    # a train cell's batch as the port's rank holds it (whisper's frames whole)
    blk = cell.meta.get("batch_block", {})
    if "whole" in blk:
        layout = lm.batch_layout(cell.cfg, shape_mesh(mesh_shape), cell.shape.global_batch,
                                 cell.shape.seq_len)
        port = _nbytes(rank_block(input_specs(cell.cfg, cell.shape), layout))
        out["batch_reference"], out["batch"] = out["batch"], port
    # a decode cell's state as the port's rank holds it
    if cell.shape.kind == "decode":
        state, _ = _decode_state(cell, shape_mesh(mesh_shape))
        ref, out["state"], out["cache"] = out["state"], _nbytes(state), _nbytes(state["cache"])
        if ref != out["state"]:
            out["state_reference"] = ref
    out["total"] = sum(v for k, v in out.items()
                       if k not in ("cache", "state_reference", "batch_reference"))
    return out


def refusal(cell: Cell, mesh_shape: dict[str, int], policy_name: str) -> str:
    """The message the port's CLI gives for this cell, or ``""`` where it
    runs it: the training CLI's for a train cell, the serving CLI's for
    prefill (the paged engine) and decode (the lock-step engine, the
    reference's decode step)."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    dp, model = dp_size(mesh_shape), mesh_shape["model"]
    msgs = []
    try:
        if cell.shape.kind == "train":
            train_cli._refuse_unported(argparse.Namespace(
                data_mesh=dp, model_mesh=model, world_size=1,
                global_batch=cell.shape.global_batch, seq_len=cell.shape.seq_len), cell.cfg,
                mesh_shape)
        else:
            engine = "paged" if cell.shape.kind == "prefill" else "lockstep"
            serve_cli._refuse_unported(argparse.Namespace(
                data_mesh=dp, model_mesh=model, engine=engine), cell.cfg)
    except NotImplementedError as e:
        msgs.append(str(e))
    return "; ".join(msgs)


# ----------------------------------------------------------------------
# running a cell's step on the fake mesh
# ----------------------------------------------------------------------


def step_census(cell: Cell, mesh, *, opt_cfg=None):
    """Run the cell's step once as this rank of ``mesh`` (a fake mesh, on
    meta) under the census; returns its counts. Train: the params, Adam
    state and batch are the rank's shards and block of the batch
    (``models/model.py::batch_layout``), the step the
    training CLI's ``make_train_step`` at the cell's accumulation; prefill:
    ``make_prefill_step`` on the rank's rows; decode: the lock-step
    engine's ``make_serve_step`` on the rank's serving params (k/v whole
    under seq-sharded decode), rows and cache shard."""
    from repro_torch.analysis.dispatch_walk import Census

    cfg, shape = cell.cfg, cell.shape
    params, _ = steps_lib.abstract_state(cfg)
    decode = shape.kind == "decode"
    specs = lm.mesh_specs(cfg, params, mesh.shape, replicate_kv=decode and cfg.decode_seq_shard)
    local = shd.shard_tree(params, specs, mesh, consume=True)
    if decode:
        state, layout = _decode_state(cell, mesh)
        fn = steps_lib.make_serve_step(cfg, mesh=mesh, layout=layout)
        args = (lm.decode_params(cfg, local, mesh), state)
        with Census(args=args) as c:
            out = fn(*args)
        return c.finish(out)
    # the rank's block of the global batch, on meta (fresh tensors: the
    # census counts an argument's storage)
    layout = lm.batch_layout(cfg, mesh, shape.global_batch, shape.seq_len)
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in rank_block(input_specs(cfg, shape), layout).items()}
    if shape.kind == "train":
        sharded = shd.map_specs(lambda _, sp: shd.is_split(sp), local, specs)
        opt = adam.init(local)
        fn = steps_lib.make_train_step(cfg, cell.table, opt_cfg or adam.AdamConfig(
            lr=2e-4, clip_norm=1.0), accum=cell.meta["accum"], mesh=mesh, sharded=sharded,
            layout=layout)
        args = (local, opt, batch)
    elif shape.kind == "prefill":
        fn = steps_lib.make_prefill_step(cfg, mesh=mesh)
        args = (lm.decode_params(cfg, local, mesh), batch)
    with Census(args=args) as c:
        out = fn(*args)
    return c.finish(out)


def census_record(counts) -> dict:
    """The numbers a cell records of its step's census."""
    by_kind = counts.collectives_by_kind()
    return {
        "arg_bytes": counts.arg_bytes,
        "peak_bytes": counts.peak_bytes,
        "flops": counts.flops,
        "kernel_tile_flops": counts.kernel_flops,
        "kernel_product_flops": counts.kernel_product_flops,
        "launches": counts.launches_by_name(),
        "host_syncs": len(counts.syncs),
        "host_sync_ops": sorted({s.op for s in counts.syncs}),
        "dead_flops": counts.dead_flops,
        "collectives": by_kind,
        "collective_calls": sum(v["calls"] for v in by_kind.values()),
        "collective_bytes": sum(v["bytes"] for v in by_kind.values()),
    }


def run_cell(arch, shape_name, mesh_kind, policy_name, out_dir=None, verbose=True,
             placements_only=False, rank=0):
    """One cell: its record (see the module docstring)."""
    from repro_torch.launch.mesh import make_production_mesh

    mesh_shape = production_mesh_shape(multi_pod=(mesh_kind == "multi"))
    world = 1
    for n in mesh_shape.values():
        world *= n
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "policy": policy_name,
           "devices": world, "rank": rank}
    t0 = time.time()
    cell, why = build_cell(arch, shape_name, mesh_shape, policy_name)
    tag = f"{arch} × {shape_name} × {mesh_kind} × {policy_name}"
    if cell is None:
        rec.update(status="skipped", skipped=why)
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {mesh_kind}: SKIP ({why})")
        return rec
    rec.update(cell.meta)
    rec["placements"] = placement_report(cell)
    rec["rank_bytes"] = rank_bytes(cell, mesh_shape)
    if placements_only:
        rec["status"] = "ok"
        if verbose:
            print(f"[dryrun] {tag}: placements")
            for k, v in rec["placements"]["inputs"].items():
                print(f"  {k}: {v}")
            print(json.dumps(rec["placements"]))
        return rec
    why = refusal(cell, mesh_shape, policy_name)
    if why:
        rec.update(status="unsupported", unsupported=why)
    else:
        try:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), rank=rank)
            seq = ("seq_calls", "seq_bytes", "kv_sum_calls", "kv_sum_bytes")
            parallel.counters.update(dict.fromkeys(seq, 0))
            rec["step"] = census_record(step_census(cell, mesh))
            if parallel.counters["seq_calls"]:  # the sequence split's, the cross K/V sums apart
                rec["step"]["seq_split"] = {k: parallel.counters[k] for k in seq}
            rec["status"] = "ok"
        except Exception as e:
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
    rec["seconds"] = round(time.time() - t0, 2)
    if verbose:
        gib = rec["rank_bytes"]["total"] / 2**30
        extra = f" args/rank={gib:.2f}GiB"
        if rec["status"] == "ok":
            st = rec["step"]
            extra += (f" peak/rank={st['peak_bytes'] / 2**30:.2f}GiB flops/rank={st['flops']:.3e}"
                      f" kernel_tile_flops/rank={st['kernel_tile_flops']:.3e}"
                      f" launches={st['launches']} syncs={st['host_syncs']}"
                      f" collectives={st['collective_calls']} calls/"
                      f"{st['collective_bytes'] / 2**30:.3f}GiB")
            if "seq_split" in st:
                sq = st["seq_split"]
                extra += (f" seq_split={sq['seq_calls']} calls/{sq['seq_bytes'] / 2**30:.3f}GiB"
                          f" kv_sums={sq['kv_sum_calls']} calls/"
                          f"{sq['kv_sum_bytes'] / 2**30:.3f}GiB")
        elif rec["status"] == "unsupported":
            extra += f" ({rec['unsupported']})"
        else:
            extra += f" {rec.get('error')}"
        print(f"[dryrun] {tag}: {rec['status']}{extra} ({rec['seconds']}s)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        if rec["status"] == "ok":
            rec.pop("traceback", None)
        with open(os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}__{policy_name}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--policy", choices=POLICIES, default="ssprop")
    ap.add_argument("--all", action="store_true", help="every (arch × shape)")
    ap.add_argument("--placements-only", action="store_true",
                    help="report input placements (JSON) without running any step")
    ap.add_argument("--rank", type=int, default=0, help="the rank this process plays")
    ap.add_argument("--out", default="",
                    help="write one JSON a cell into this directory (e.g. build/dryrun, "
                    "git-ignored); default: stdout only")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    failures = 0
    for a, s in cells:
        rec = run_cell(a, s, args.mesh, args.policy, out_dir=args.out or None,
                       placements_only=args.placements_only, rank=args.rank)
        if rec["status"] == "error":
            failures += 1
            print(rec.get("traceback", rec.get("error")))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
