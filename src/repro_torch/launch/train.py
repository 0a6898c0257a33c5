"""Fault-tolerant LM training with ssProp (the port's ``repro.launch.train``).

Wires together: config registry -> synthetic token pipeline -> params
and Adam state on one device -> a resolved ssProp **policy program**
(per-site rules x schedule; the paper's epoch-bar schedule alternates a
dense epoch and a sparse one) -> one train step per step's policy table
-> async checkpointing -> heartbeat + restart policy. On restart it
resumes from the latest committed checkpoint; the pure-function-of-step
data pipeline makes the replay exact. Checkpoints are the JAX package's
format and layout (``checkpoint/ckpt.py``): a run either package started
resumes in the other.

The reference's flags and defaults, plus:

  * ``--device`` (default ``cuda``; asking for ``cuda`` without a card
    raises: there is no fall-back to the CPU);
  * the ``SsPropPolicy`` fields that pick the backward route:
    ``--use-pallas`` (the shrunk products through the hand-written
    kernels: ``matmul`` at channel granularity, ``dx_gathered`` /
    ``dw_gathered`` at block granularity) and ``--block-size``.

``--no-scan-layers`` is accepted and changes nothing: the port always
unrolls the layer stack. PyTorch runs eagerly, so where the reference
keeps one compiled step per schedule bucket the port asks the program
for the step's table and runs it.

**Device meshes** (``--data-mesh D --model-mesh M``, the reference's
flags): the one command spawns ``D*M`` ranks, one process each
(``launch/mesh.py::run_on_mesh``; NCCL when each rank has a card, gloo
when they share one or run on the CPU), and returns rank 0's dict. Each
rank holds its shards of the params and of Adam's moments (the JAX
package's partition specs, ``models/model.py::mesh_specs``), steps its
block of the global batch (``models/model.py::batch_layout``, from the
reference's fitted batch spec: its ``B/D`` rows; where ``--data-mesh``
does not divide the batch, its block of the sequence, the K/V and the
SSM's state passed between the ranks; where it divides neither, the
whole batch, as every data rank holds it), and computes what the
one-device step computes: the loss, the updated params and the kept
channels (``dist/parallel.py``, ``core/sparsity.py::select_on_mesh``). A
checkpoint on a mesh is the JAX package's sharded format, a
``shard_<r>.msgpack`` a rank, committed by rank 0; a restart restores
it and each rank keeps its slices. Every family runs on a mesh (experts
split over ``model``, SSM heads split over ``model``, the encoder and the
cross-decoder as the decoder stack; under a sequence split the encoder
runs alike on every rank of the group, and the VLM's patches split with
its tokens). Still refused, naming the ROADMAP item that ports it: a VLM
layout whose fitted spec splits the tokens' sequence but not the patches
(none on the production meshes).

The token pipeline gives tokens alone, as the reference's does; for the
encoder-decoder and VLM families the port adds the stubbed frontends'
outputs to each batch (``data/pipeline.py::frontend_inputs``: frames or
patches drawn from the seed and the step), which the reference's CLI
lacks (it trains those families through ``make_train_step`` only).

**Multi-process mode** (``--coord-dir`` + ``--world-size N`` +
``--rank r``): every rank runs this driver as its own OS process against
a shared coordination directory. Each rank heartbeats, the leader
(lowest active rank) runs the :class:`FleetSupervisor` poll, and every
step is guarded by a membership-epoch check — a stale rank is evicted
(epoch bump), survivors abort with ``MembershipChanged`` and restart
resharded from the last committed checkpoint, and a relaunched rank
rejoins through the un-evict protocol. Checkpoints are **per-host
sharded**: each rank writes only ``shard_<r>.msgpack`` and the leader
commits once every active peer's shard lands. Compute is replicated
across ranks (every rank steps the full global batch), as in the
reference.

**A fleet on a mesh** (both sets of flags): each fleet rank is one
launcher process that spawns its ``D*M`` mesh ranks, and each mesh steps
the full global batch, so the fleet's losses are those of one mesh of
that shape, bit for bit. Mesh rank 0 of each fleet rank is the fleet
rank's seat: it alone beats, registers, supervises, logs the losses and
writes the done marker, each under the fleet rank's number. It runs the
step's fleet check and hands the verdict to the other mesh ranks
(:func:`lead_verdict`), so that every mesh rank aborts at the same step
and the restart runs on all of them together. A checkpoint is the fleet's
format (``shard_<fleet rank>.msgpack``, a plan over the active fleet
ranks), each fleet rank's pieces gathered from its mesh ranks' shards. A
mesh rank ends with its launcher (``launch/mesh.py::run_on_mesh``), and a
mesh rank that fails ends its launcher with an error, so a launcher's
death or failure stops its heartbeat and the fleet evicts it.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 8 --steps-per-epoch 2 --granularity channel --use-pallas
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 12 --steps-per-epoch 4 --global-batch 4 --seq-len 32 \\
      --ckpt-dir /tmp/run1 --ckpt-every 4 --fail-at-step 6
  # a 2x2 mesh, 4 ranks over gloo on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 4 --steps-per-epoch 2 --global-batch 4 --seq-len 16 \\
      --use-pallas --data-mesh 2 --model-mesh 2
  # 2-rank fleet on one machine (each line its own process):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 12 --ckpt-dir /tmp/fleet/ckpt --ckpt-every 4 \\
      --coord-dir /tmp/fleet --world-size 2 --rank 0  # ... --rank 1
  # the same fleet, each rank's launcher on a 1x2 mesh (add to each line):
  #   --data-mesh 1 --model-mesh 2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import resource
import time

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import backward
from repro_torch.core.policy import PolicyProgram, PolicyRules, paper_default, tpu_default
from repro_torch.core.schedulers import make_schedule
from repro_torch.data.pipeline import (
    TokenPipeline,
    TokenPipelineConfig,
    frontend_inputs,
    rank_block,
)
from repro_torch.dist import compat as dist_compat
from repro_torch.dist import parallel
from repro_torch.dist import sharding as shd
from repro_torch.dist.fault import (
    FleetSupervisor,
    Heartbeat,
    HeartbeatThread,
    MembershipChanged,
    RestartPolicy,
    StragglerSupervisor,
)
from repro_torch.kernels import gathered_matmul as gm
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import run_on_mesh, shape_mesh
from repro_torch.launch.precision import fp32_precision
from repro_torch.models import model as lm
from repro_torch.models import moe
from repro_torch.optim import adam


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--drop-rate", type=float, default=0.8)
    ap.add_argument("--scheduler", default="epoch_bar")
    ap.add_argument("--steps-per-epoch", type=int, default=10)
    ap.add_argument("--period", type=int, default=100,
                    help="periodic_bar scheduler period (iterations)")
    ap.add_argument("--granularity", choices=["channel", "block"], default="channel")
    ap.add_argument("--block-size", type=int, default=128,
                    help="channel-block width at --granularity block")
    ap.add_argument("--use-pallas", action=argparse.BooleanOptionalAction, default=False,
                    help="shrunk backward products through the hand-written CUDA kernels "
                    "(the SsPropPolicy field's name is the JAX package's)")
    ap.add_argument("--rules", default="",
                    help="per-site rules 'pattern=rate;...' over the model's site names "
                    "(rate may be 'dense'); empty = one global rule at --drop-rate")
    ap.add_argument("--no-scan-layers", action="store_true",
                    help="accepted for the reference's command lines; the port always "
                    "unrolls the layer stack")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a crash once (fault-tolerance demo/test)")
    # multi-process fleet (see the module docstring)
    ap.add_argument("--coord-dir", default="",
                    help="shared coordination dir; with --world-size > 1 "
                         "enables the rank-complete fault protocol and "
                         "per-host sharded checkpoints")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--hb-interval", type=float, default=1.0,
                    help="seconds between heartbeat touches")
    ap.add_argument("--hb-timeout", type=float, default=5.0,
                    help="heartbeat staleness before eviction")
    ap.add_argument("--commit-timeout", type=float, default=30.0,
                    help="leader wait for peers' checkpoint shards")
    ap.add_argument("--rejoin-timeout", type=float, default=60.0,
                    help="evicted rank's wait to be re-admitted")
    ap.add_argument("--step-delay", type=float, default=0.0,
                    help="sleep per step (chaos tests: stretch the run "
                         "so a kill lands mid-training)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def build_program(args, base_policy) -> PolicyProgram:
    """The one control surface: rules (site patterns) x schedule."""
    schedule = make_schedule(
        args.scheduler,
        target=args.drop_rate,
        total_steps=args.steps,
        steps_per_epoch=args.steps_per_epoch,
        period=args.period,
        rate_buckets=base_policy.rate_buckets,
    )
    if args.rules:
        rules = PolicyRules.parse(args.rules, base=base_policy)
    else:
        rules = PolicyRules.single(base_policy)
    return PolicyProgram(rules=rules, schedule=schedule)


def _refuse_unported(args, cfg, mesh_shape=None) -> None:
    """The mesh combinations the port does not run yet, each with the
    ROADMAP item that ports it. ``mesh_shape``: the mesh the batch layout
    is read on (default ``--data-mesh x --model-mesh``; the dry run's has
    a ``pod`` axis)."""
    if args.data_mesh * args.model_mesh == 1:
        return
    asked = []
    try:
        lm.batch_layout(cfg, shape_mesh(mesh_shape or {"data": args.data_mesh,
                                                       "model": args.model_mesh}),
                        args.global_batch, args.seq_len)
    except NotImplementedError as e:
        asked.append(str(e))
    asked += lm.mesh_unported(cfg, args.model_mesh)
    if asked:
        raise NotImplementedError(f"{'; '.join(asked)}: not ported yet (ROADMAP Queue 1 item 5)")


def _config(args):
    """The ``--arch`` config, reduced with ``--reduced``."""
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args, *, cfg=None, collect=(), timeout_s: float | None = None) -> dict:
    """Train ``args.steps`` steps in full fp32 where the model is fp32
    (TF32 off, as the JAX package computes), resuming from the latest
    committed checkpoint of ``--ckpt-dir`` and restarting after a
    failure as the reference does. Returns, for every step run (a step
    replayed after a restart appears again): its index, loss, MoE
    load-balance loss (``aux``, 0 without MoE layers), scheduled drop rate
    and wall time (the step ends in a device sync); the launches of each
    kernel over the run; the checkpoint saves' and restores' sizes and
    times; and the TF32 flags that were in force.

    On a mesh (``--data-mesh`` x ``--model-mesh`` > 1) the ranks run in
    spawned processes and this is rank 0's dict, plus every rank's
    kernel launches (``launches_by_rank``) beside what
    ``kernel_launches_per_step`` says each should launch
    (``launch_table_by_rank``). ``cfg`` trains another config than the
    ``--arch`` one (a depth or dtype cut; the CLI has no flag for either,
    as the reference's has none). ``collect`` adds, for tests and the
    card's checks: ``"kept"``, the kept channels of every step and site
    (global indices, all ranks' merged); ``"params"``, the final params
    gathered to full tensors (``name -> tensor`` on the host);
    ``timeout_s`` bounds a mesh run."""
    cfg = cfg or _config(args)  # the ranks train what the caller resolved
    _refuse_unported(args, cfg)
    if args.data_mesh * args.model_mesh > 1:
        return run_on_mesh(run_rank, args.data_mesh, args.model_mesh, args.device, args,
                           cfg, tuple(collect), timeout_s=timeout_s)
    with fp32_precision() as tf32:
        out = _train(args, cfg=cfg, collect=tuple(collect))
    return {**out, "tf32": tf32}


def run_rank(mesh, args, cfg=None, collect=()):
    """One rank's part of a mesh run (what :func:`run` spawns): its dict,
    every rank's launches among them."""
    with fp32_precision() as tf32:
        out = _train(args, mesh, cfg=cfg, collect=collect)
    return {**out, "tf32": tf32}


def lead_verdict(mesh, fn):
    """``fn()`` on mesh rank 0 (the only rank without a mesh), its result
    or its error handed to every mesh rank, so that what only rank 0 runs
    (the fleet's checks, the leader's commit) makes every rank return or
    raise at the same point: a rank that raised alone would leave its
    peers waiting in the next collective. A :class:`MembershipChanged`
    is raised on every rank as itself, with the membership; any other
    error as a ``RuntimeError`` that names it (rank 0 raises its own)."""
    if mesh is None:
        return fn()
    verdict, err = None, None
    if mesh.rank == 0:
        try:
            verdict = ("ok", fn())
        except MembershipChanged as e:
            verdict, err = ("changed", e.membership), e
        except Exception as e:
            verdict, err = ("error", f"{type(e).__name__}: {e}"), e
    kind, value = parallel.broadcast_object(verdict)
    if kind == "ok":
        return value
    if err is not None:
        raise err
    if kind == "changed":
        raise MembershipChanged(value)
    raise RuntimeError(f"mesh rank 0 raised {value}")


def global_kept(cfg, site: str, sel, mesh) -> list[int]:
    """A rank's kept channels of ``site`` as global output channels."""
    idx = sel.idx if sel.valid is None else sel.idx[sel.valid]
    if mesh is not None and lm.mesh_split(cfg, site, mesh.model) == "col":
        idx = idx + mesh.model_rank * (lm.site_out_dim(cfg, site) // mesh.model)
    return sorted(set(int(i) for i in idx))


def _spec_leaves(tree) -> list:
    """The :class:`~repro_torch.dist.sharding.Spec` leaves of a tree in the
    checkpoint's flattening order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def _train(args, mesh=None, *, cfg=None, collect=()) -> dict:
    device = torch.device(args.device) if mesh is None else mesh.device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available (pass --device cpu)")
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = cfg or _config(args)
    pipe = TokenPipeline(
        TokenPipelineConfig(cfg.vocab, args.seq_len, args.global_batch, args.seed)
    )
    base_policy = dataclasses.replace(
        paper_default(args.drop_rate) if args.granularity == "channel"
        else tpu_default(args.drop_rate),
        block_size=args.block_size, use_pallas=args.use_pallas,
    )
    program = build_program(args, base_policy)
    sites, depth = lm.site_names(cfg)
    resolved = program.resolve(sites, depth=depth)
    opt_cfg = adam.AdamConfig(lr=args.lr, clip_norm=1.0, total_steps=args.steps)

    ckpt_dir = args.ckpt_dir
    # the fleet rank names the loss log, the heartbeat, the registration,
    # the checkpoint shard and the done marker; on a mesh only mesh rank 0
    # runs or writes them
    rank, world, coord_dir = args.rank, args.world_size, args.coord_dir
    multi = bool(coord_dir) and world > 1
    fleet_mesh = None if not multi else mesh  # whom the fleet's verdicts reach
    layout = None
    if mesh is not None:
        layout = lm.batch_layout(cfg, mesh, args.global_batch, args.seq_len)
        step_dp = layout.step_mesh(mesh).dp  # the data ranks that split the tokens

    sup = hb = loss_log = None
    if coord_dir:
        if lead:
            # per-rank loss log (jsonl, append-only): replayed steps after a
            # restart append AGAIN, so readers take the LAST occurrence of a
            # step — exactly the value an uninterrupted run would have
            os.makedirs(os.path.join(coord_dir, "loss"), exist_ok=True)
            loss_log = os.path.join(coord_dir, "loss", f"rank_{rank:05d}.jsonl")
        # every process's pid (a mesh rank each), for a check that none
        # outlives its launcher
        os.makedirs(os.path.join(coord_dir, "pids"), exist_ok=True)
        mesh_rank = 0 if mesh is None else mesh.rank
        with open(os.path.join(coord_dir, "pids", f"rank_{rank:05d}_mesh_{mesh_rank}"), "w") as f:
            f.write(str(os.getpid()))
    if multi:
        def join_fleet() -> None:
            nonlocal hb, sup
            # background beater: heartbeat = PROCESS liveness, so a rank in a
            # long first step is not falsely evicted while a SIGKILLed one is
            # detected within --hb-timeout
            hb = Heartbeat(os.path.join(coord_dir, "hb"), rank=rank, interval_s=args.hb_interval)
            HeartbeatThread(hb).start()
            dist_compat.initialize(coord_dir, process_id=rank, num_processes=world,
                                   timeout_s=args.rejoin_timeout)
            sup = FleetSupervisor(coord_dir, world, timeout_s=args.hb_timeout)

        lead_verdict(fleet_mesh, join_fleet)
    elif ckpt_dir and lead:
        hb = Heartbeat(os.path.join(ckpt_dir, "hb"), rank=rank)
    strag = StragglerSupervisor()
    restart_policy = RestartPolicy(max_restarts=3, backoff_s=0.1)
    rec = {k: [] for k in ("steps", "history", "aux", "rates", "step_times")}
    ckpt_stats = {"saves": [], "restores": []}
    injected = {"done": False}
    before = dict(gm.launches)
    table = {k: 0 for k in gm.launches}  # the launches kernel_launches_per_step says
    kept: dict[int, dict[str, list[int]]] = {}

    def log_loss(step: int, loss: float) -> None:
        if loss_log:
            with open(loss_log, "a") as f:
                f.write(json.dumps({"step": step, "loss": loss}) + "\n")

    def jax_state(params, opt_state):
        """params, m and v in the JAX layout, each stack a lazy leaf that
        a checkpoint's snapshot stacks on the host."""
        return {k: lm.jax_layout(cfg, t, ckpt_lib.Stacked)
                for k, t in (("params", params), ("m", opt_state.m), ("v", opt_state.v))}

    def fresh_state():
        """Params from the seed and zero moments; on a mesh this rank's
        shards of them, with the specs and which leaves ``model`` splits."""
        params = lm.init_params(cfg, args.seed, device=device)
        if mesh is None:
            return params, adam.init(params), None, None
        specs = lm.mesh_specs(cfg, params, mesh.shape)
        local = shd.shard_tree(params, specs, mesh)
        del params
        sharded = shd.map_specs(lambda _, sp: shd.is_split(sp), local, specs)
        return local, adam.init(local), specs, sharded

    mesh_ckpt = {}  # on a mesh: the full state's like, its leaves' specs, the mesh's plan

    def plan_saves(local, specs) -> None:
        """The full state's shapes (``meta`` tensors) from this rank's
        shards and their specs, each leaf's spec fitted to the mesh, and
        (outside a fleet) the plan of the pieces each rank writes of them:
        ``plan_from_specs`` over the mesh's ranks."""
        meta = shd.map_specs(
            lambda t, sp: torch.empty(
                [d * (mesh.shape[sp[i]] if i < len(sp) and sp[i] else 1)
                 for i, d in enumerate(t.shape)], dtype=t.dtype, device="meta"),
            local, specs)
        like = ckpt_lib.like_of(jax_state(meta, adam.init(meta)))
        jspecs = _spec_leaves(shd.param_specs(lm.jax_layout(cfg, meta, lm.StackShape))) * 3
        items = ckpt_lib.leaf_items(like)
        mesh_ckpt.update(like=like, specs=[
            shd.fit_spec(sp, t.shape, mesh.shape) for sp, (_, t) in zip(jspecs, items, strict=True)])
        if not multi:
            mesh_ckpt["plan"] = ckpt_lib.plan_from_specs(items, jspecs, mesh.shape,
                                                         list(range(mesh.world)))

    def enter_fleet():
        """The membership this attempt trains under; an evicted rank files
        a rejoin request and waits to be re-admitted."""
        m = sup.view.read()
        if rank not in m.active:
            # we were evicted (crash, stall, ...) — file a rejoin
            # request and wait for the supervisor to re-admit us
            sup.request_rejoin(rank)
            print(f"[train] rank {rank} evicted; requesting rejoin")
            m = sup.wait_active(rank, timeout_s=args.rejoin_timeout)
        return m

    def attempt(attempt_idx: int):
        if restart_policy.excluded_ranks:
            say(f"[train] resharding around ranks {restart_policy.excluded_ranks}")
        membership = None
        active = [rank]
        if multi:
            membership = lead_verdict(fleet_mesh, enter_fleet)
            active = list(membership.active)
            say(f"[train] rank {rank} attempt {attempt_idx}: "
                f"epoch {membership.epoch} active={active}")
        params, opt_state, specs, sharded = fresh_state()
        if mesh is not None and ckpt_dir and not mesh_ckpt:
            plan_saves(params, specs)
        saver = None
        if ckpt_dir and multi and mesh is not None:
            saver = ckpt_lib.AsyncCheckpointer(
                ckpt_dir, rank=rank, ranks=active, commit_timeout_s=args.commit_timeout,
                like=mesh_ckpt["like"], mesh=mesh, specs=mesh_ckpt["specs"])
        elif ckpt_dir:
            saver = ckpt_lib.AsyncCheckpointer(
                ckpt_dir, rank=rank if mesh is None else mesh.rank,
                ranks=active if multi else list(range(mesh.world)) if mesh else None,
                commit_timeout_s=args.commit_timeout, plan=mesh_ckpt.get("plan"),
                like=mesh_ckpt.get("like"),
            )
        start = 0
        latest = None
        if ckpt_dir and mesh is not None:
            # every rank's last save has landed and rank 0 has committed
            # it (its saver waited) before any rank looks; rank 0's answer
            # is every rank's
            parallel.barrier(mesh)
            latest = parallel.broadcast_object(ckpt_lib.latest_step(ckpt_dir))
        elif ckpt_dir:
            latest = ckpt_lib.latest_step(ckpt_dir)
        if latest is not None:
            like_now = (ckpt_lib.like_of(jax_state(params, opt_state)) if mesh is None
                        else mesh_ckpt["like"])
            del params, opt_state  # the restored state takes their place on the device
            t0 = time.perf_counter()
            state = ckpt_lib.restore(ckpt_dir, latest, like_now)
            # every leaf whole on the host at once, on each rank of a mesh
            host_bytes = sum(t.numel() * t.element_size()
                             for _, t in ckpt_lib.leaf_items(state))
            trees = [lm.params_from_jax(cfg, state[k], device) for k in ("params", "m", "v")]
            del state
            if mesh is not None:
                trees = [shd.shard_tree(t, specs, mesh) for t in trees]
            params = trees[0]
            opt_state = adam.restored(latest, trees[1], trees[2])
            del trees
            _sync(device)
            ckpt_stats["restores"].append({
                "step": latest, "s": time.perf_counter() - t0, "host_bytes": host_bytes,
                # this process's peak resident bytes so far (the restore's, where it is the top)
                "peak_rss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024})
            start = latest
            say(f"[train] resumed from step {latest}")
        try:
            for step in range(start, args.steps):
                if multi:
                    def check(epoch=membership.epoch):
                        if sup.should_poll(rank):
                            sup.poll()
                        # abort + reshard if the fleet changed under us
                        return sup.check_epoch(epoch)

                    membership = lead_verdict(fleet_mesh, check)
                if step == args.fail_at_step and not injected["done"]:
                    injected["done"] = True
                    raise RuntimeError("injected failure (fault-tolerance test)")
                if args.step_delay > 0:
                    time.sleep(args.step_delay)
                policies = resolved.policies_for_step(step)
                fn = steps_lib.make_train_step(cfg, policies, opt_cfg, mesh=mesh,
                                               sharded=sharded, layout=layout)
                rate = program.schedule.rate(step)
                batch = dict(pipe.batch_at(step),
                             **frontend_inputs(cfg, args.global_batch, args.seed, step))
                if mesh is not None:
                    batch = rank_block(batch, layout)
                batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
                _sync(device)
                t0 = time.perf_counter()
                # a mesh rank's launches depend on which sites kept none of
                # its channels: the step's selections say
                watch = mesh is not None or "kept" in collect
                with (backward.record_selections() if watch
                      else contextlib.nullcontext([])) as log:
                    params, opt_state, metrics = fn(params, opt_state, batch)
                loss = metrics["loss"].item()  # waits for the step
                _sync(device)
                dt = time.perf_counter() - t0
                if mesh is not None:
                    per = lm.kernel_launches_per_step(
                        cfg, policies, model=mesh.model, data=step_dp,
                        tokens=args.global_batch * args.seq_len,
                        idle_sites={site for site, sel in log if sel.k == 0},
                        seq_split=layout.seq_split)
                    for k, v in per.items():
                        table[k] += v
                if "kept" in collect:
                    site_of = _site_of(params) if mesh is None else None
                    got: dict[str, set[int]] = {}
                    for key, sel in log:  # an expert of several groups: their union
                        site = site_of[key] if mesh is None else key
                        got.setdefault(site, set()).update(global_kept(cfg, site, sel, mesh))
                    kept[step] = {site: sorted(v) for site, v in got.items()}
                strag.record(rank, dt)
                strag.check(excluded=restart_policy.excluded_ranks)
                if hb:
                    hb.beat()
                rec["steps"].append(step)
                rec["history"].append(loss)
                rec["aux"].append(float(metrics["aux"]))
                rec["rates"].append(rate)
                rec["step_times"].append(dt)
                log_loss(step, loss)
                if step % args.log_every == 0 or step == args.steps - 1:
                    say(f"[train] step {step:5d} rate={rate:.2f} loss={loss:.4f} "
                        f"aux={rec['aux'][-1]:.4f} ({dt * 1e3:.0f} ms)")
                if saver and (step + 1) % args.ckpt_every == 0:
                    saver.save(step + 1, jax_state(params, opt_state))
                    ckpt_stats["saves"].append(saver.last_stats)
                    # a copy: the write's thread adds its seconds to the dict
                    say(f"[train] saved step {step + 1}: {json.dumps(dict(saver.last_stats))}",
                        flush=True)
        except BaseException:
            # a single process lets its last save land before the restart
            # looks for it; a fleet's leader may be waiting on a dead peer
            if saver and not multi:
                saver.wait()
            raise
        if saver:
            def landed():
                saver.wait()
                # a failed FINAL save must not report success — mid-run
                # save errors (e.g. a torn commit after a peer died)
                # surface on the next attempt's restore instead
                if saver.last_error is not None:
                    raise saver.last_error

            lead_verdict(fleet_mesh, landed)
        if "params" in collect:
            rec["params"] = params if mesh is None else shd.gather_tree(params, specs, mesh)
        return rec["history"][-1] if rec["history"] else None

    final = restart_policy.run(
        attempt,
        on_restart=lambda i, e: say(f"[train] restart {i}: {e}"),
        on_evict=lambda r, e: say(f"[train] evicted straggler rank {r}: {e}"),
        on_reshard=lambda m: say(
            f"[train] rank {rank} resharding to epoch {m.epoch} active={list(m.active)}"
        ),
    )
    if coord_dir and lead:
        # durable completion marker for the multi-process harness
        os.makedirs(os.path.join(coord_dir, "done"), exist_ok=True)
        done = os.path.join(coord_dir, "done", f"rank_{rank:05d}.json")
        tmp = f"{done}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"rank": rank, "final_loss": final, "steps": args.steps}, f)
        os.replace(tmp, done)
    launches = {k: gm.launches[k] - before[k] for k in gm.launches}
    # the LM step runs eagerly, on a mesh and off it (ROADMAP Queue 1 item 2)
    out = {**rec, "final_loss": final, "launches": launches, "ckpt": ckpt_stats,
           "captured": False}
    if mesh is not None:
        names = sorted(launches)
        mine = torch.tensor([[launches[k] for k in names], [table[k] for k in names]],
                            dtype=torch.int64, device=device)
        every = parallel.all_gather(mine[None], None, mesh.world, dim=0).cpu()
        out["launches_by_rank"] = [dict(zip(names, r[0].tolist(), strict=True)) for r in every]
        out["launch_table_by_rank"] = [dict(zip(names, r[1].tolist(), strict=True))
                                       for r in every]
        if "kept" in collect:
            import torch.distributed as dist

            every_kept = [None] * mesh.world
            dist.all_gather_object(every_kept, kept)
            kept = {step: {site: sorted({i for k in every_kept for i in k[step].get(site, ())})
                           for site in set().union(*(k[step] for k in every_kept))}
                    for step in every_kept[0]}
    if "kept" in collect:
        out["kept"] = kept
    if "params" in collect:
        out["params"] = {k: v.cpu() for k, v in named_params(out.pop("params")).items()}
    return out


def _site_of(params) -> dict[int, str]:
    """weight ``data_ptr`` -> site name over every product of the model (a
    routed expert's ``moe/gate[e]`` and the like, as a mesh names it)."""
    out = {}
    for name, w in named_params(params).items():
        site, _, leaf = name.rpartition("/")
        if leaf == "w" and w.dim() == 2:
            out[w.data_ptr()] = site
        elif lm.is_expert_site(name) and w.dim() == 3:
            layer = name.split("/moe/", 1)[0]
            for e in range(w.shape[0]):
                out[w[e].data_ptr()] = f"{layer}/{moe.expert_site(leaf, e)}"
    return out


def named_params(params) -> dict[str, torch.Tensor]:
    """``name -> tensor`` over a param tree: ``embed/table``,
    ``layer_{li}/attn/q/w`` and so on (the encoder's layers
    ``enc/layer_{i}/...``, the cross-decoder's ``layer_{li}/...``)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        else:
            out[prefix[:-1]] = node

    stacks = {"stack": "", "decoder": "", "encoder": "enc/"}
    walk({k: v for k, v in params.items() if k not in stacks}, "")
    for key, pre in stacks.items():
        for li, layer in enumerate(params.get(key, {}).get("layers", [])):
            walk(layer, f"{pre}layer_{li}/")
    return out


def main():
    args = build_parser().parse_args()
    out = run(args)
    if out["final_loss"] is None:
        print("[train] nothing to do: already at the target step")
    else:
        print(f"[train] done. final loss {out['final_loss']:.4f}")
    print("[train] kernel launches:", out["launches"])
    print(f"[train] steps captured as CUDA graphs: {out['captured']}")
    if "launches_by_rank" in out:
        print("[train] kernel launches by mesh rank:", json.dumps(
            {"launches": out["launches_by_rank"], "table": out["launch_table_by_rank"]}))
    if any(out["ckpt"].values()):
        print("[train] checkpoint:", json.dumps(out["ckpt"]))


if __name__ == "__main__":
    main()
