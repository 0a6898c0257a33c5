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
unrolls the layer stack. ``--data-mesh`` / ``--model-mesh`` > 1 raise:
meshes are not ported yet. PyTorch runs eagerly, so where the reference
keeps one compiled step per schedule bucket the port asks the program
for the step's table and runs it.

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

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 8 --steps-per-epoch 2 --granularity channel --use-pallas
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 12 --steps-per-epoch 4 --global-batch 4 --seq-len 32 \\
      --ckpt-dir /tmp/run1 --ckpt-every 4 --fail-at-step 6
  # 2-rank fleet on one machine (each line its own process):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 12 --ckpt-dir /tmp/fleet/ckpt --ckpt-every 4 \\
      --coord-dir /tmp/fleet --world-size 2 --rank 0  # ... --rank 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.policy import PolicyProgram, PolicyRules, paper_default, tpu_default
from repro_torch.core.schedulers import make_schedule
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
from repro_torch.dist import compat as dist_compat
from repro_torch.dist.fault import (
    FleetSupervisor,
    Heartbeat,
    HeartbeatThread,
    RestartPolicy,
    StragglerSupervisor,
)
from repro_torch.kernels import gathered_matmul as gm
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.precision import fp32_precision
from repro_torch.models import model as lm
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


def _refuse_unported(args) -> None:
    unported = {
        "--data-mesh > 1": args.data_mesh > 1,
        "--model-mesh > 1": args.model_mesh > 1,
    }
    asked = [flag for flag, on in unported.items() if on]
    if asked:
        raise NotImplementedError(f"{', '.join(asked)}: meshes are not ported yet")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """Train ``args.steps`` steps in full fp32 where the model is fp32
    (TF32 off, as the JAX package computes), resuming from the latest
    committed checkpoint of ``--ckpt-dir`` and restarting after a
    failure as the reference does. Returns, for every step run (a step
    replayed after a restart appears again): its index, loss, MoE
    load-balance loss (``aux``, 0 without MoE layers), scheduled drop rate
    and wall time (the step ends in a device sync); the launches of each
    kernel over the run; the checkpoint saves' and restores' sizes and
    times; and the TF32 flags that were in force."""
    _refuse_unported(args)
    with fp32_precision() as tf32:
        out = _train(args)
    return {**out, "tf32": tf32}


def _train(args) -> dict:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available (pass --device cpu)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
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
    rank, world, coord_dir = args.rank, args.world_size, args.coord_dir
    multi = bool(coord_dir) and world > 1

    sup = None
    loss_log = None
    if coord_dir:
        # per-rank loss log (jsonl, append-only): replayed steps after a
        # restart append AGAIN, so readers take the LAST occurrence of a
        # step — exactly the value an uninterrupted run would have
        os.makedirs(os.path.join(coord_dir, "loss"), exist_ok=True)
        loss_log = os.path.join(coord_dir, "loss", f"rank_{rank:05d}.jsonl")
    if multi:
        # background beater: heartbeat = PROCESS liveness, so a rank in a
        # long first step is not falsely evicted while a SIGKILLed one is
        # detected within --hb-timeout
        hb = Heartbeat(os.path.join(coord_dir, "hb"), rank=rank, interval_s=args.hb_interval)
        HeartbeatThread(hb).start()
        dist_compat.initialize(coord_dir, process_id=rank, num_processes=world,
                               timeout_s=args.rejoin_timeout)
        sup = FleetSupervisor(coord_dir, world, timeout_s=args.hb_timeout)
    else:
        hb = Heartbeat(os.path.join(ckpt_dir, "hb"), rank=0) if ckpt_dir else None
    strag = StragglerSupervisor()
    restart_policy = RestartPolicy(max_restarts=3, backoff_s=0.1)
    rec = {k: [] for k in ("steps", "history", "aux", "rates", "step_times")}
    ckpt_stats = {"saves": [], "restores": []}
    injected = {"done": False}
    before = dict(gm.launches)

    def log_loss(step: int, loss: float) -> None:
        if loss_log:
            with open(loss_log, "a") as f:
                f.write(json.dumps({"step": step, "loss": loss}) + "\n")

    def jax_state(params, opt_state):
        """params, m and v in the JAX layout, each stack a lazy leaf that
        a checkpoint's snapshot stacks on the host."""
        return {k: lm.jax_layout(cfg, t, ckpt_lib.Stacked)
                for k, t in (("params", params), ("m", opt_state.m), ("v", opt_state.v))}

    def attempt(attempt_idx: int):
        if restart_policy.excluded_ranks:
            print(f"[train] resharding around ranks {restart_policy.excluded_ranks}")
        membership = None
        active = [rank]
        if multi:
            membership = sup.view.read()
            if rank not in membership.active:
                # we were evicted (crash, stall, ...) — file a rejoin
                # request and wait for the supervisor to re-admit us
                sup.request_rejoin(rank)
                print(f"[train] rank {rank} evicted; requesting rejoin")
                membership = sup.wait_active(rank, timeout_s=args.rejoin_timeout)
            active = list(membership.active)
            print(f"[train] rank {rank} attempt {attempt_idx}: "
                  f"epoch {membership.epoch} active={active}")
        saver = None
        if ckpt_dir:
            saver = ckpt_lib.AsyncCheckpointer(
                ckpt_dir, rank=rank, ranks=active if multi else None,
                commit_timeout_s=args.commit_timeout,
            )
        params = lm.init_params(cfg, args.seed, device=device)
        opt_state = adam.init(params)
        start = 0
        latest = ckpt_lib.latest_step(ckpt_dir) if ckpt_dir else None
        if latest is not None:
            like = ckpt_lib.like_of(jax_state(params, opt_state))
            del params, opt_state  # the restored state takes their place on the device
            t0 = time.perf_counter()
            state = ckpt_lib.restore(ckpt_dir, latest, like)
            params = lm.params_from_jax(cfg, state["params"], device)
            opt_state = adam.restored(latest, lm.params_from_jax(cfg, state["m"], device),
                                      lm.params_from_jax(cfg, state["v"], device))
            del state
            _sync(device)
            ckpt_stats["restores"].append({"step": latest, "s": time.perf_counter() - t0})
            start = latest
            print(f"[train] resumed from step {latest}")
        try:
            for step in range(start, args.steps):
                if multi:
                    if sup.should_poll(rank):
                        sup.poll()
                    # abort + reshard if the fleet changed under us
                    membership = sup.check_epoch(membership.epoch)
                if step == args.fail_at_step and not injected["done"]:
                    injected["done"] = True
                    raise RuntimeError("injected failure (fault-tolerance test)")
                if args.step_delay > 0:
                    time.sleep(args.step_delay)
                fn = steps_lib.make_train_step(cfg, resolved.policies_for_step(step), opt_cfg)
                rate = program.schedule.rate(step)
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in pipe.batch_at(step).items()}
                _sync(device)
                t0 = time.perf_counter()
                params, opt_state, metrics = fn(params, opt_state, batch)
                loss = metrics["loss"].item()  # waits for the step
                _sync(device)
                dt = time.perf_counter() - t0
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
                    print(f"[train] step {step:5d} rate={rate:.2f} loss={loss:.4f} "
                          f"aux={rec['aux'][-1]:.4f} ({dt * 1e3:.0f} ms)")
                if saver and (step + 1) % args.ckpt_every == 0:
                    saver.save(step + 1, jax_state(params, opt_state))
                    ckpt_stats["saves"].append(saver.last_stats)
        except BaseException:
            # a single process lets its last save land before the restart
            # looks for it; a fleet's leader may be waiting on a dead peer
            if saver and not multi:
                saver.wait()
            raise
        if saver:
            saver.wait()
            if saver.last_error is not None:
                # a failed FINAL save must not report success — mid-run
                # save errors (e.g. a torn commit after a peer died)
                # surface on the next attempt's restore instead
                raise saver.last_error
        return rec["history"][-1] if rec["history"] else None

    final = restart_policy.run(
        attempt,
        on_restart=lambda i, e: print(f"[train] restart {i}: {e}"),
        on_evict=lambda r, e: print(f"[train] evicted straggler rank {r}: {e}"),
        on_reshard=lambda m: print(
            f"[train] rank {rank} resharding to epoch {m.epoch} active={list(m.active)}"
        ),
    )
    if coord_dir:
        # durable completion marker for the multi-process harness
        os.makedirs(os.path.join(coord_dir, "done"), exist_ok=True)
        done = os.path.join(coord_dir, "done", f"rank_{rank:05d}.json")
        tmp = f"{done}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"rank": rank, "final_loss": final, "steps": args.steps}, f)
        os.replace(tmp, done)
    return {
        **rec,
        "final_loss": final,
        "launches": {k: gm.launches[k] - before[k] for k in gm.launches},
        "ckpt": ckpt_stats,
    }


def main():
    args = build_parser().parse_args()
    out = run(args)
    if out["final_loss"] is None:
        print("[train] nothing to do: already at the target step")
    else:
        print(f"[train] done. final loss {out['final_loss']:.4f}")
    print("[train] kernel launches:", out["launches"])


if __name__ == "__main__":
    main()
