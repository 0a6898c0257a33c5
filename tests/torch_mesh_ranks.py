"""Rank bodies the mesh tests spawn (``launch/mesh.py::run_on_mesh``).

They live apart from the test files so that a spawned rank, which
imports the module its function comes from, imports the port alone and
not JAX. Each returns every rank's results to rank 0
(``all_gather_object``), which ``run_on_mesh`` hands to the test;
:func:`on_shapes` runs several mesh shapes of one size in one spawn.
"""
import dataclasses

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import backward
from repro_torch.core import policy as tpolicy
from repro_torch.core import sparsity
from repro_torch.core.dense import sparse_dense
from repro_torch.dist import parallel
from repro_torch.dist import sharding as shd
from repro_torch.models import model as tlm

ARCH = "qwen2.5-3b"


def _named(tree, prefix=""):
    """``path -> leaf`` over dicts and lists (a list index is a path part)."""
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _named(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _named(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def on_shapes(mesh, calls):
    """Each ``(data, model): (fn, args)`` of ``calls`` on that mesh over
    this spawn's ranks (every shape's size the world's, so one spawn
    serves them all): ``{shape: fn(mesh, *args)}``."""
    from repro_torch.launch.mesh import make_host_mesh

    out = {}
    for shape, (fn, args) in calls.items():
        m = mesh if shape == (mesh.data, mesh.model) else make_host_mesh(*shape, "cpu")
        out[shape] = fn(m, *args)
    return out


def in_turn(mesh, calls):
    """Each ``(fn, args)`` of ``calls`` on ``mesh``, in turn: their results."""
    return [fn(mesh, *args) for fn, args in calls]


def spawn_shapes(calls, keys, timeout_s):
    """Run ``calls`` (``{shape: (fn, args)}``, ``fn`` returning a list)
    with one spawn of gloo ranks on the CPU for the shapes of each size,
    and key each shape's results by ``keys[shape]``: ``{key: result}``."""
    from repro_torch.launch import mesh as tmesh

    out = {}
    for world in sorted({d * m for d, m in calls}):
        group = {sh: c for sh, c in calls.items() if sh[0] * sh[1] == world}
        res = tmesh.run_on_mesh(on_shapes, *next(iter(group)), "cpu", group, timeout_s=timeout_s)
        for shape, got in res.items():
            out.update(zip(keys[shape], got, strict=True))
    return out


def mesh_cases(mesh, tree):
    """Every case of one mesh shape, on one rank (module-level: spawned
    ranks import it). ``tree``: the JAX init of reduced qwen2.5-3b
    (numpy, JAX layout). Returns every rank's results (rank 0's copy)."""
    import torch.distributed as dist

    torch.manual_seed(0)
    cfg = get_config(ARCH).reduced()
    params = tlm.params_from_jax(cfg, tree, device="cpu")
    specs = tlm.mesh_specs(cfg, params, mesh.shape)
    local = shd.shard_tree(params, specs, mesh)
    named_p, named_s, named_l = _named(params), _named(specs), _named(local)
    out = {"rank": mesh.rank, "coord": (mesh.data_rank, mesh.model_rank),
           "specs": {k: tuple(v) for k, v in named_s.items()},
           "local": {k: v.numpy() for k, v in named_l.items()}}
    full = _named(shd.gather_tree(local, specs, mesh))
    out["gather_eq"] = all(torch.equal(full[k], v) for k, v in named_p.items())

    g = torch.Generator().manual_seed(1)
    m, r = mesh.model, mesh.model_rank
    f = {}

    def cols(t, n=m, i=r):
        w = t.shape[-1] // n
        return t[..., i * w:(i + 1) * w]

    # copy_to_model at a column-parallel product's input
    x = torch.randn(4, 8, generator=g, dtype=torch.float64)
    w = torch.randn(8, 12, generator=g, dtype=torch.float64)
    c = torch.randn(4, 12, generator=g, dtype=torch.float64)
    xa = x.clone().requires_grad_(True)
    (parallel.copy_to_model(xa, mesh) @ cols(w) * cols(c)).sum().backward()
    xp = x.clone().requires_grad_(True)
    (xp @ w * c).sum().backward()
    f["copy_to_model"] = float((xa.grad - xp.grad).abs().max())
    # reduce_from_model at a row-parallel product's output
    xa = cols(x).clone().requires_grad_(True)
    wa = w[r * 8 // m:(r + 1) * 8 // m].clone().requires_grad_(True)
    y = parallel.reduce_from_model(xa @ wa, mesh)
    (y * c).sum().backward()
    xp = x.clone().requires_grad_(True)
    wp = w.clone().requires_grad_(True)
    yp = xp @ wp
    (yp * c).sum().backward()
    f["reduce_from_model"] = max(float((y - yp).abs().max()),
                                 float((xa.grad - cols(xp.grad)).abs().max()),
                                 float((wa.grad - wp.grad[r * 8 // m:(r + 1) * 8 // m]).abs().max()))
    # slice_for_model: the replicated bias, its gradient gathered whole
    b = torch.randn(12, generator=g, dtype=torch.float64, requires_grad=True)
    bl = parallel.slice_for_model(b, mesh)
    (bl * cols(c[0])).sum().backward()
    f["slice_for_model"] = max(float((bl - cols(b)).abs().max()), float((b.grad - c[0]).abs().max()))
    # gather_from_model: gather-on-use; the (replicated) gradient sliced back
    wl = cols(w).clone().requires_grad_(True)
    wf = parallel.gather_from_model(wl, mesh)
    (x @ wf * c).sum().backward()
    wp = w.clone().requires_grad_(True)
    (x @ wp * c).sum().backward()
    f["gather_from_model"] = max(float((wf - w).abs().max()),
                                 float((wl.grad - cols(wp.grad)).abs().max()))
    # sum_over_data: each data rank's share of a global sum
    s = torch.arange(1.0, 4.0, dtype=torch.float64) * (mesh.data_rank + 1)
    sa = s.clone().requires_grad_(True)
    tot = parallel.sum_over_data(sa.sum(), mesh)
    tot.backward()
    f["sum_over_data"] = max(abs(float(tot) - 6.0 * sum(range(1, mesh.data + 1))),
                             float((sa.grad - 1).abs().max()))
    # the vocab-parallel embedding
    table = torch.randn(16, 4, generator=g, dtype=torch.float64)
    tok = torch.randint(0, 16, (3, 5), generator=g)
    tl = table[r * 16 // m:(r + 1) * 16 // m].clone().requires_grad_(True)
    e = parallel.vocab_embed(tl, tok, mesh)
    cw = torch.randn(3, 5, 4, generator=g, dtype=torch.float64)
    (e * cw).sum().backward()
    tp = table.clone().requires_grad_(True)
    ep = tp[tok]
    (ep * cw).sum().backward()
    f["vocab_embed"] = max(float((e - ep).abs().max()),
                           float((tl.grad - tp.grad[r * 16 // m:(r + 1) * 16 // m]).abs().max()))
    # the vocab-parallel cross-entropy (fp32, as the model runs it), the
    # last 3 ids padding, and the full rows gathered for sampling
    logits = torch.randn(3, 5, 16, generator=g) * 4
    tgt = torch.randint(0, 13, (3, 5), generator=g)
    gw = torch.rand(3, 5, generator=g)
    la = cols(logits).clone().requires_grad_(True)
    nll = parallel.vocab_cross_entropy(la, tgt, 13, mesh)
    (nll * gw).sum().backward()
    lp = logits.clone().requires_grad_(True)
    masked = torch.cat([lp[..., :13], torch.full_like(lp[..., 13:], -1e30)], -1)
    ref = -torch.gather(torch.log_softmax(masked, -1), -1, tgt[..., None])[..., 0]
    (ref * gw).sum().backward()
    f["vocab_cross_entropy"] = max(float((nll - ref).abs().max()),
                                   float((la.grad - cols(lp.grad)).abs().max()))
    f["gather_vocab"] = float((parallel.gather_vocab(cols(logits), mesh) - logits).abs().max())
    out["functions"] = f

    # select_on_mesh: this rank's rows and columns of one dY
    dy = torch.randn(8, 256, generator=g) * torch.linspace(0.1, 3.0, 256)[torch.randperm(256, generator=g)]
    rows = dy[mesh.data_rank * 8 // mesh.data:(mesh.data_rank + 1) * 8 // mesh.data]
    sel = {}
    for name, pol in (("channel", tpolicy.paper_default(0.8)), ("block", dataclasses.replace(
            tpolicy.tpu_default(0.8), block_size=32)), ("tp", dataclasses.replace(
            tpolicy.paper_default(0.8), tp_shards=m))):
        got_c = sparsity.select_on_mesh(cols(rows), pol, parallel.SiteMesh(mesh, col=True))
        got_r = sparsity.select_on_mesh(rows, pol, parallel.SiteMesh(mesh, col=False),
                                        n_shards=sparsity.selection_shards(pol, 256))
        sel[name] = (sorted((got_c.idx + r * (256 // m)).tolist()), got_c.block_idx is not None,
                     got_r.idx.tolist())
    out["select"] = sel

    # the program's own instruments: the collectives' counters (time only
    # within timed_collectives) and a mesh site's recorded output gradient
    parallel.counters.update(calls=0, bytes=0, s=0.0)
    parallel.all_reduce(torch.ones(4, dtype=torch.float64), mesh.model_group)
    with parallel.timed_collectives():
        parallel.all_gather(torch.ones(3), mesh.data_group, mesh.data)
    out["counters"] = dict(parallel.counters)
    xs = torch.randn(6, 8, generator=g)
    ws = cols(torch.randn(8, 12, generator=g)).clone().requires_grad_(True)
    up = cols(torch.randn(6, 12, generator=g))
    with backward.record_cotangents(["probe", "absent"]) as dys:
        y = sparse_dense(xs, ws, None, policy=tpolicy.paper_default(0.5),
                         mesh=parallel.SiteMesh(mesh, col=True, site="probe"))
        (y * up).sum().backward()
    out["cotangents"] = {k: torch.equal(v, up) for k, v in dys.items()}

    every = [None] * mesh.world
    dist.all_gather_object(every, out)
    return every


def train_cases(mesh, argvs, tp=None):
    """Each command line through the training CLI's rank body
    (``train.run_rank``), the kept channels and the gathered final params
    collected; then, given ``tp = (tree, lr)``, :func:`tp_case`. Returns
    the runs' dicts (rank 0's)."""
    from repro_torch.launch import train

    outs = [train.run_rank(mesh, train.build_parser().parse_args(argv), None, ("kept", "params"))
            for argv in argvs]
    if tp is not None:
        outs.append(tp_case(mesh, *tp))
    return outs


def tp_case(mesh, tree, lr, batch=4, seq=16):
    """Three steps of reduced qwen2.5-3b from the JAX init ``tree`` on the
    mesh through ``make_train_step``: dense, then two at
    ``paper_default(0.8)`` with ``use_pallas`` and ``tp_shards`` = the
    model size, each rank's shards its own selection's. Returns the
    losses, the kept channels (global, every rank's merged), every rank's
    ``kops.matmul`` calls beside the launch table's count, and the
    gathered params."""
    import torch.distributed as dist

    from repro_torch.core import backward
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.optim import adam

    cfg = get_config(ARCH).reduced()
    params = tlm.params_from_jax(cfg, tree, device="cpu")
    specs = tlm.mesh_specs(cfg, params, mesh.shape)
    local = shd.shard_tree(params, specs, mesh)
    sharded = shd.map_specs(lambda _, sp: shd.is_split(sp), local, specs)
    opt = adam.init(local)
    ocfg = adam.AdamConfig(lr=lr, clip_norm=1.0, total_steps=3)
    pol = dataclasses.replace(tpolicy.paper_default(0.8), use_pallas=True, tp_shards=mesh.model)
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab, seq, batch, 0))
    rows = batch // mesh.data
    calls = {"matmul": 0}
    raw = kops.matmul

    def counted(a, b):
        calls["matmul"] += 1
        return raw(a, b)

    losses, kept, table = [], {}, 0
    kops.matmul = counted
    try:
        for step, p in enumerate((tpolicy.DENSE, pol, pol)):
            b = {k: torch.from_numpy(v[mesh.data_rank * rows:(mesh.data_rank + 1) * rows])
                 for k, v in pipe.batch_at(step).items()}
            fn = steps_lib.make_train_step(cfg, p, ocfg, mesh=mesh, sharded=sharded)
            with backward.record_selections() as log:
                local, opt, metrics = fn(local, opt, b)
            losses.append(float(metrics["loss"]))
            kept[step] = {site: train.global_kept(cfg, site, sel, mesh) for site, sel in log}
            idle = {site for site, sel in log if sel.k == 0}
            table += tlm.kernel_launches_per_step(cfg, p, model=mesh.model,
                                                  idle_sites=idle)["matmul"]
    finally:
        kops.matmul = raw
    every = [None] * mesh.world
    dist.all_gather_object(every, (kept, calls["matmul"], table))
    merged = {st: {s: sorted({i for k, _, _ in every for i in k[st][s]}) for s in kept[st]}
              for st in kept}
    full = train.named_params(shd.gather_tree(local, specs, mesh))
    return {"history": losses, "kept": merged, "matmul_calls": [c for _, c, _ in every],
            "matmul_table": [t for _, _, t in every],
            "params": {k: v.clone() for k, v in full.items()}}


def family_train(mesh, arch, tree, overrides, batches, lr):
    """Three steps of the reduced ``arch`` (``overrides`` replaced in its
    config) from the JAX init ``tree`` on the mesh through
    ``make_train_step``: dense, then two at ``paper_default(0.8)`` with
    ``use_pallas``, each rank stepping its block of ``batches`` (one
    numpy dict a step, frames or patches among them; its rows, or where
    the data axes do not divide the batch its block of the sequence, by
    ``model.batch_layout``). Returns the losses,
    each step's ``dropped`` a MoE layer (``moe_apply``'s, global on every
    rank), the kept channels of every site and routed expert (global,
    every rank's merged; a selection over an all-zero dY, an expert no
    token of a group reached, keeps none, as its dW shows), every rank's
    ``kops.matmul`` calls beside the launch table's count, the gathered
    params, the rank's block (``rows``, ``seq``) and each step's
    sequence-split collectives (``dist/parallel.py::counters``), of those
    the cross-attention K/V gradient sums apart, and the layout's patch
    block and ``whole`` inputs."""
    import torch.distributed as dist

    from repro_torch.kernels import ops as kops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    from repro_torch.models import moe
    from repro_torch.optim import adam

    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    params = tlm.params_from_jax(cfg, tree, device="cpu")
    specs = tlm.mesh_specs(cfg, params, mesh.shape)
    local = shd.shard_tree(params, specs, mesh)
    sharded = shd.map_specs(lambda _, sp: shd.is_split(sp), local, specs)
    opt = adam.init(local)
    ocfg = adam.AdamConfig(lr=lr, clip_norm=1.0, total_steps=len(batches))
    pol = dataclasses.replace(tpolicy.paper_default(0.8), use_pallas=True)
    from repro_torch.data.pipeline import rank_block

    n_rows, seq = batches[0]["tokens"].shape
    layout = tlm.batch_layout(cfg, mesh, n_rows, seq)
    step_dp = layout.step_mesh(mesh).dp
    calls, dropped, live, seq_colls, kv_sums = {"matmul": 0}, [], [], [], []
    raw_mm, raw_moe, raw_sel = kops.matmul, moe.moe_apply, sparsity.select_on_mesh

    def counted(a, b):
        calls["matmul"] += 1
        return raw_mm(a, b)

    def recorded(*a, **k):
        y, m = raw_moe(*a, **k)
        dropped[-1].append(float(m["dropped"]))
        return y, m

    def selecting(dy, *a, **k):  # a selection over an all-zero dY keeps nothing
        live.append(bool(dy.abs().sum() > 0))
        return raw_sel(dy, *a, **k)

    losses, kept, table = [], {}, 0
    kops.matmul, moe.moe_apply, sparsity.select_on_mesh = counted, recorded, selecting
    try:
        for step, p in enumerate((tpolicy.DENSE, pol, pol)):
            b = {k: torch.from_numpy(v) for k, v in rank_block(batches[step], layout).items()}
            fn = steps_lib.make_train_step(cfg, p, ocfg, mesh=mesh, sharded=sharded,
                                           layout=layout)
            dropped.append([])
            live.clear()
            parallel.counters.update(seq_calls=0, seq_bytes=0, kv_sum_calls=0, kv_sum_bytes=0)
            with backward.record_selections() as log:
                local, opt, metrics = fn(local, opt, b)
            seq_colls.append((parallel.counters["seq_calls"], parallel.counters["seq_bytes"]))
            kv_sums.append((parallel.counters["kv_sum_calls"], parallel.counters["kv_sum_bytes"]))
            losses.append(float(metrics["loss"]))
            got = {}
            for (site, sel), nonzero in zip(log, live, strict=True):
                got.setdefault(site, set()).update(
                    train.global_kept(cfg, site, sel, mesh) if nonzero else ())
            kept[step] = got
            idle = {site for site, sel in log if sel.k == 0}
            table += tlm.kernel_launches_per_step(
                cfg, p, model=mesh.model, data=step_dp, tokens=n_rows * seq, idle_sites=idle,
                seq_split=layout.seq_split)["matmul"]
    finally:
        kops.matmul, moe.moe_apply, sparsity.select_on_mesh = raw_mm, raw_moe, raw_sel
    every = [None] * mesh.world
    dist.all_gather_object(every, (kept, calls["matmul"], table))
    merged = {st: {s: sorted(set().union(*(k[st].get(s, set()) for k, _, _ in every)))
                   for s in set().union(*(k[st] for k, _, _ in every))} for st in kept}
    full = train.named_params(shd.gather_tree(local, specs, mesh))
    return {"history": losses, "dropped": dropped, "kept": merged,
            "matmul_calls": [c for _, c, _ in every],
            "matmul_table": [t for _, _, t in every],
            "params": {k: v.clone() for k, v in full.items()},
            "rows": layout.rows, "seq": layout.seq, "seq_collectives": seq_colls,
            "patches": layout.patches, "whole": list(layout.whole), "kv_sum_collectives": kv_sums}


def seq_train(mesh, shape, arch, tree, overrides, batches, lr):
    """:func:`family_train` on a ``(pod, data, model)`` mesh ``shape`` over
    this spawn's ranks (a pod mesh made here), the batch's rows or its
    sequence split as the fitted spec places the data axes."""
    from repro_torch.launch.mesh import make_host_mesh

    pod, data, model = shape
    if (pod, data, model) != (1, mesh.data, mesh.model):
        mesh = make_host_mesh(data, model, "cpu", pod=pod)
    return family_train(mesh, arch, tree, overrides, batches, lr)


def serve_cases(mesh, tree, dtree, modes, max_seq, cli_argv, arch=ARCH, overrides=None):
    """The engine on a model mesh, once a mode: the reduced ``arch``'s
    (``overrides`` replaced in its config) params from the JAX init
    ``tree`` (a 1-layer drafter's from ``dtree``, or none), this rank's
    shards of them, the mode's workload
    (``modes[name] = (workload kwargs, ServeConfig kwargs, drafter?,
    greedy-every-other?)``). Returns ``{name: (streams, stats, every
    rank's paged_attention launches, every rank's swapped bytes, whether
    every rank's streams are rank 0's)}`` and, last (given ``cli_argv``),
    the serving CLI's rank body on it."""
    import torch.distributed as dist

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve
    from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, poisson_workload

    cfg = dataclasses.replace(get_config(arch).reduced(), **(overrides or {}))
    dcfg = cfg.reduced(n_layers=1)

    def local(c, t):  # the serving CLI's shards
        p = tlm.params_from_jax(c, t, device="cpu")
        return tlm.decode_params(c, shd.shard_tree(p, tlm.mesh_specs(c, p, mesh.shape), mesh), mesh)

    params = local(cfg, tree)
    dparams = None if dtree is None else local(dcfg, dtree)
    out = {}
    for name, (wkw, skw, draft, mixed) in modes.items():
        kw = dict(draft_cfg=dcfg, draft_params=dparams) if draft else {}
        eng = ContinuousBatchingEngine(cfg, params, ServeConfig(max_seq=max_seq, prefill_chunk=4,
                                                                **skw),
                                       device="cpu", mesh=mesh, **kw)
        reqs = poisson_workload(cfg, **wkw)
        if mixed:
            for r in reqs[::2]:
                r.sampling = type(r.sampling)()
        for r in reqs:
            eng.submit(r)
        before = pa.launches
        streams = {rid: list(map(int, toks)) for rid, toks in eng.run().items()}
        stats = eng.stats()
        every = [None] * mesh.world
        dist.all_gather_object(every, (streams, pa.launches - before, stats["swapped_bytes"]))
        out[name] = (streams, stats, [n for _, n, _ in every], [b for _, _, b in every],
                     all(s == streams for s, _, _ in every))
    if cli_argv is not None:
        args = serve.build_parser().parse_args(cli_argv)
        out["cli"] = serve.serve_rank(mesh, args, cfg)["generated"].tolist()
    return out


def lockstep_streams(mesh, arch, tree, cases, max_seq):
    """The lock-step engine (``serve.generate_lockstep``) on this mesh,
    once a case (``cases[name] = (prompts [B, P], gen, config overrides,
    frames or None)``; ``decode_seq_shard`` among the overrides splits the
    contiguous K/V's sequence over ``model``, the k/v kernels whole):
    ``{name: (tokens [B, gen], the layout's (slots, seq), whether every
    rank's tokens are rank 0's)}``."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.serve import generate_lockstep

    base = get_config(arch).reduced()
    out = {}
    for name, (prompts, gen, overrides, frames) in cases.items():
        cfg = dataclasses.replace(base, **overrides)
        params = _serve_params(mesh, cfg, tree)
        b = prompts.shape[0]
        layout = tlm.cache_layout(cfg, mesh, b, max_seq, seq_shard=cfg.decode_seq_shard)
        with torch.no_grad():
            res = generate_lockstep(cfg, params, prompts, [gen] * b, max_seq=max_seq,
                                    frames=frames, device="cpu", mesh=mesh)
        tokens = np.stack(res["tokens"])
        every = [None] * mesh.world
        dist.all_gather_object(every, tokens.tolist())
        out[name] = (tokens, (layout.slots, layout.seq),
                     all(t == tokens.tolist() for t in every))
    return out


def span_gather_case(mesh, shape, n_heads, head_dim):
    """``parallel.gather_span_from_model`` on this rank of a ``(data,
    model)`` mesh ``shape`` over this spawn's ranks, ``n_heads`` heads of
    ``head_dim`` whose q columns the model ranks split (fp64): each
    rank weighs its head span of the gathered q by its own cotangent, so
    ranks that share a head send different gradients into its columns.
    Returns every rank's (span, forward error, gradient error against the
    summed one-process gradient, the plain ``gather_from_model``'s
    gradient error, whether a second backward is bit-identical)."""
    import types

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers

    if tuple(shape) != (mesh.data, mesh.model):
        mesh = make_host_mesh(*shape, "cpu")
    cfg = types.SimpleNamespace(n_heads=n_heads, n_kv_heads=n_heads, head_dim=head_dim)
    m, r = mesh.model, mesh.model_rank
    spans = [tuple(head_dim * e for e in layers.head_span(cfg, m, j).q) for j in range(m)]
    width, c = n_heads * head_dim, n_heads * head_dim // m
    q = torch.randn(3, width, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    cot = [torch.randn(3, hi - lo, generator=torch.Generator().manual_seed(1 + j),
                       dtype=torch.float64) for j, (lo, hi) in enumerate(spans)]
    want = torch.zeros_like(q)  # d/dq of every rank's weighted span, summed
    for (lo, hi), w in zip(spans, cot, strict=True):
        want[:, lo:hi] += w
    grads, outs = [], []
    for summed in (True, True, False):  # twice, then the plain gather (its backward slices)
        ql = q[:, r * c:(r + 1) * c].clone().requires_grad_(True)
        if summed:
            out = parallel.gather_span_from_model(ql, mesh, spans)
        else:
            out = parallel.gather_from_model(ql, mesh)[:, spans[r][0]:spans[r][1]]
        (out * cot[r]).sum().backward()
        grads.append(ql.grad)
        outs.append(out.detach())
    fwd = float((outs[0] - q[:, spans[r][0]:spans[r][1]]).abs().max())
    mine = want[:, r * c:(r + 1) * c]
    res = (layers.head_span(cfg, m, r), fwd, float((grads[0] - mine).abs().max()),
           float((grads[2] - mine).abs().max()), torch.equal(grads[0], grads[1]))
    every = [None] * mesh.world
    dist.all_gather_object(every, res)
    return every


def cli_train(mesh, argvs):
    """Each command line through the training CLI's rank body: its
    losses (checkpoints, if asked for, land in its ``--ckpt-dir``)."""
    from repro_torch.launch import train

    return [train.run_rank(mesh, train.build_parser().parse_args(argv))["history"]
            for argv in argvs]


def counted_step(mesh, arch, policy, batch, seq):
    """One training step of the reduced ``arch`` at ``policy`` on this
    rank (seed-0 params, the token pipeline's first batch): the
    collectives' calls and bytes (``dist/parallel.py::counters``) and the
    kernel wrappers' calls by name, which on the card are their launches
    (the CPU runs the plain versions). Returns every rank's (rank 0's
    copy), to hold the dry run's census on the fake group to."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels import gathered_matmul as gm
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import adam

    cfg = get_config(arch).reduced()
    params = tlm.init_params(cfg, 0, device="cpu")
    specs = tlm.mesh_specs(cfg, params, mesh.shape)
    local = shd.shard_tree(params, specs, mesh)
    sharded = shd.map_specs(lambda _, sp: shd.is_split(sp), local, specs)
    opt = adam.init(local)
    fn = steps_lib.make_train_step(cfg, policy, adam.AdamConfig(lr=2e-4, clip_norm=1.0),
                                   mesh=mesh, sharded=sharded)
    rows = batch // mesh.data
    data = TokenPipeline(TokenPipelineConfig(cfg.vocab, seq, batch, 0)).batch_at(0)
    b = {k: torch.from_numpy(v[mesh.data_rank * rows:(mesh.data_rank + 1) * rows])
         for k, v in data.items()}
    calls = dict.fromkeys(gm.launches, 0)
    raw = {name: getattr(gm, name) for name in calls}

    def counting(name):
        def call(*a, **k):
            calls[name] += 1
            return raw[name](*a, **k)
        return call

    for name in calls:
        setattr(gm, name, counting(name))
    parallel.counters.update(calls=0, bytes=0, s=0.0)
    try:
        fn(local, opt, b)
    finally:
        for name, f in raw.items():
            setattr(gm, name, f)
    mine = {"rank": mesh.rank, "calls": parallel.counters["calls"],
            "bytes": parallel.counters["bytes"], "launches": {k: v for k, v in calls.items() if v},
            "param_bytes": sum(t.numel() * t.element_size() for t in adam.tree_leaves(local)),
            "adam_bytes": sum(t.numel() * t.element_size()
                              for t in adam.tree_leaves([opt.m, opt.v])) + 4}
    every = [None] * mesh.world
    dist.all_gather_object(every, mine)
    return every


def _serve_params(mesh, cfg, tree):
    """This rank's serving shards of the JAX init ``tree`` (k/v whole under
    ``cfg.decode_seq_shard``), as the serving CLI makes them."""
    p = tlm.params_from_jax(cfg, tree, device="cpu")
    specs = tlm.mesh_specs(cfg, p, mesh.shape, replicate_kv=cfg.decode_seq_shard)
    return tlm.decode_params(cfg, shd.shard_tree(p, specs, mesh), mesh)


def data_serve_cases(mesh, arch, tree, dtree, modes, max_seq):
    """The engine on a ``data x model`` mesh, once a mode (``modes`` as
    :func:`serve_cases` takes them): ``{name: (streams, stats, every rank's
    paged_attention launches, every rank's swapped bytes, whether every
    rank's streams are rank 0's, whether every data rank's pools equal
    this model rank's after every step, the (swap-out, swap-in) slot pairs
    of its swaps)}``. A pool's bits are compared through a checksum a
    step (``serve.pool_checksum``)."""
    import torch.distributed as dist

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve
    from repro_torch.serve import ContinuousBatchingEngine, ServeConfig, poisson_workload
    from repro_torch.serve.cache import PagedCacheManager

    cfg = get_config(arch).reduced()
    dcfg = cfg.reduced(n_layers=2 if cfg.attn_every else 1)
    params = _serve_params(mesh, cfg, tree)
    dparams = None if dtree is None else _serve_params(mesh, dcfg, dtree)
    out = {}
    for name, (wkw, skw, draft, mixed) in modes.items():
        kw = dict(draft_cfg=dcfg, draft_params=dparams) if draft else {}
        eng = ContinuousBatchingEngine(cfg, params, ServeConfig(max_seq=max_seq, prefill_chunk=4,
                                                                **skw),
                                       device="cpu", mesh=mesh, **kw)
        reqs = poisson_workload(cfg, **wkw)
        if mixed:
            for r in reqs[::2]:
                r.sampling = type(r.sampling)()
        for r in reqs:
            eng.submit(r)
        swaps, staged = [], {}
        if isinstance(eng.slots, PagedCacheManager):
            mgr, out_fn, in_fn = eng.slots, eng.slots.swap_out, eng.slots.swap_in

            def swap_out(slot, out_fn=out_fn):
                bundle = out_fn(slot)
                staged[id(bundle)] = slot
                return bundle

            def swap_in(slot, bundle, in_fn=in_fn):
                swaps.append((staged[id(bundle)], slot))
                return in_fn(slot, bundle)

            mgr.swap_out, mgr.swap_in = swap_out, swap_in
        before = pa.launches
        sums = []
        while eng.waiting or eng.by_slot:
            eng.run(max_ticks=1)
            if isinstance(eng.slots, PagedCacheManager):
                sums.append(serve.pool_checksum(eng.slots.cache))
        streams = {rid: list(map(int, toks)) for rid, toks in eng.run().items()}
        stats = eng.stats()
        every = [None] * mesh.world
        dist.all_gather_object(every, (streams, pa.launches - before, stats["swapped_bytes"],
                                       mesh.model_rank, sums))
        pools_equal = all(s == sums for _, _, _, r, s in every if r == mesh.model_rank)
        out[name] = (streams, stats, [n for _, n, _, _, _ in every],
                     [b for _, _, b, _, _ in every], all(s == streams for s, *_ in every),
                     pools_equal, swaps)
    return out


def lockstep_cases(mesh, arch, tree, cases, max_seq):
    """The lock-step decode on this mesh, once a case (``cases[name] =
    (prompts [B, P], gen, config overrides)``): teacher-forced through
    ``model.decode_step``, then greedy, every step's logits of every row
    (gathered over ``data``), and ``generate_lockstep``'s tokens (the
    serving CLI's lock-step engine). Returns ``{name: (logits [steps, B,
    V], tokens [B, gen], the layout's (slots, seq, whole))}``."""
    import numpy as np

    from repro_torch.serve import generate_lockstep

    base = get_config(arch).reduced()
    out = {}
    for name, (prompts, gen, overrides) in cases.items():
        cfg = dataclasses.replace(base, **overrides)
        params = _serve_params(mesh, cfg, tree)
        b, p = prompts.shape
        layout = tlm.cache_layout(cfg, mesh, b, max_seq, seq_shard=cfg.decode_seq_shard)
        cache = tlm.init_local_cache(cfg, layout, mesh, max_seq=max_seq, dtype=torch.float32,
                                     device="cpu")
        rows = layout.rows(prompts)
        tok = torch.from_numpy(rows[:, :1].copy())
        logits = []
        with torch.no_grad():
            for t in range(p + gen - 1):
                lg, cache = tlm.decode_step(cfg, params, tok, cache, t, mesh=mesh, layout=layout)
                if layout.split:
                    lg = parallel.gather_ids_over_data(lg, mesh)
                logits.append(lg.numpy())
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
                nxt = layout.rows(nxt) if layout.split else nxt
                tok = (torch.from_numpy(rows[:, t + 1:t + 2].copy()) if t + 1 < p
                       else nxt[:, None])
            res = generate_lockstep(cfg, params, prompts, [gen] * b, max_seq=max_seq,
                                    device="cpu", mesh=mesh)
        out[name] = (np.stack(logits), np.stack(res["tokens"]),
                     (layout.slots, layout.seq, layout.whole))
    return out


def serve_cli_rank(mesh, tree, argv):
    """The serving CLI's rank body on this mesh with the JAX init ``tree``'s
    shards as its params: the generated tokens."""
    from repro_torch.launch import serve

    cfg = get_config(ARCH).reduced()
    args = serve.build_parser().parse_args(argv)
    return serve.serve_rank(mesh, args, cfg, params=_serve_params(mesh, cfg, tree))[
        "generated"].tolist()


def fleet_abort(mesh, coord, at):
    """The training CLI's fleet check on a mesh (``train.lead_verdict``):
    steps of one collective each (the step's stand-in), a check after
    each; in the first attempt mesh rank 0, the only rank with a
    supervisor, publishes a new membership epoch at step ``at`` before its
    check. ``RestartPolicy.run`` restarts the attempt, which then runs to
    its end. Then an error that only rank 0 raises in its verdict, and one
    that only rank 1 brings to ``parallel.raise_any``. Returns every rank's
    ``(step, epoch)`` at each ``MembershipChanged`` it raised, the attempt
    that finished, and the error types it raised."""
    import torch.distributed as dist

    from repro_torch.dist.fault import FleetSupervisor, Membership, MembershipChanged, RestartPolicy
    from repro_torch.launch.train import lead_verdict

    sup = FleetSupervisor(coord, 2, timeout_s=60.0) if mesh.rank == 0 else None
    raised = []

    def attempt(i):
        m = lead_verdict(mesh, sup.view.read if sup else None)
        for step in range(at + 3):
            parallel.all_reduce(torch.ones(1), None)
            if sup is not None and i == 0 and step == at:
                sup.view.write(Membership(m.epoch + 1, m.active, ()))
            try:
                m = lead_verdict(mesh, lambda e=m.epoch: sup.check_epoch(e))
            except MembershipChanged as e:
                raised.append((step, e.membership.epoch))
                raise
        return i

    finished = RestartPolicy(max_restarts=0).run(attempt)

    def fail():
        raise TimeoutError("rank 0 alone")

    errors = []
    for call in (lambda: lead_verdict(mesh, fail),  # only rank 0 raises, in its verdict
                 lambda: parallel.raise_any(KeyError("rank 1 alone") if mesh.rank == 1 else None,
                                            mesh)):
        try:
            call()
            errors.append(None)
        except Exception as e:
            errors.append(type(e).__name__)
    every = [None] * mesh.world
    dist.all_gather_object(every, (raised, finished, errors))
    return every


def linger(mesh, pid_dir, limit_s=60.0):
    """A rank that writes its pid and then lives on for ``limit_s``,
    ignoring SIGINT (what a rank blocked in a collective's C++ wait
    does with it): only a harder signal ends it sooner."""
    import os
    import time

    with open(os.path.join(pid_dir, f"mesh_{mesh.rank}"), "w") as f:
        f.write(str(os.getpid()))
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        try:
            time.sleep(0.05)
        except KeyboardInterrupt:
            pass
