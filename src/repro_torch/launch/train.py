"""LM training entry point with ssProp (the port's ``repro.launch.train``).

Wires together: config registry -> synthetic token pipeline -> params
and Adam state on one device -> a resolved ssProp **policy program**
(per-site rules x schedule; the paper's epoch-bar schedule alternates a
dense epoch and a sparse one) -> one train step per step's policy table.

The reference's flags and defaults (``--arch --reduced --steps
--seq-len --global-batch --lr --drop-rate --scheduler --steps-per-epoch
--period --granularity --rules --seed --log-every``), plus:

  * ``--device`` (default ``cuda``; asking for ``cuda`` without a card
    raises: there is no fall-back to the CPU);
  * the ``SsPropPolicy`` fields that pick the backward route:
    ``--use-pallas`` (the shrunk products through the hand-written
    kernels: ``matmul`` at channel granularity, ``dx_gathered`` /
    ``dw_gathered`` at block granularity) and ``--block-size``.

The reference's fault tolerance, checkpoints and multi-rank fleet
(``--ckpt-dir``, ``--coord-dir``, ``--world-size`` > 1, ``--data-mesh`` /
``--model-mesh`` > 1, ``--fail-at-step``) are not ported yet: asking for
any of them raises. PyTorch runs eagerly, so where the reference keeps
one compiled step per schedule bucket the port asks the program for the
step's table and runs it.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 8 --steps-per-epoch 2 --granularity channel --use-pallas
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 4 --steps-per-epoch 2 --global-batch 2 --seq-len 16 --use-pallas
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.policy import PolicyProgram, PolicyRules, paper_default, tpu_default
from repro_torch.core.schedulers import make_schedule
from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # the reference's fault tolerance and fleet: not ported yet
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--coord-dir", default="")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--data-mesh", type=int, default=1)
    ap.add_argument("--model-mesh", type=int, default=1)
    ap.add_argument("--fail-at-step", type=int, default=-1)
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
        "--ckpt-dir": bool(args.ckpt_dir),
        "--coord-dir": bool(args.coord_dir),
        "--world-size > 1": args.world_size > 1,
        "--data-mesh > 1": args.data_mesh > 1,
        "--model-mesh > 1": args.model_mesh > 1,
        "--fail-at-step": args.fail_at_step >= 0,
    }
    asked = [flag for flag, on in unported.items() if on]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: checkpoints, fault tolerance and multi-rank training are "
            "not ported yet"
        )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """Train ``args.steps`` steps in full fp32 where the model is fp32
    (TF32 off, as the JAX package computes). Returns the loss, the MoE
    load-balance loss (``aux``, 0 without MoE layers), the scheduled drop
    rate and the wall time of every step (the step ends
    in a device sync), the launches of each kernel over the run, and the
    TF32 flags that were in force."""
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

    params = lm.init_params(cfg, args.seed, device=device)
    opt_state = adam.init(params)
    before = dict(gm.launches)
    history, aux, rates, step_times = [], [], [], []
    for step in range(args.steps):
        table = resolved.policies_for_step(step)
        fn = steps_lib.make_train_step(cfg, table, opt_cfg)
        rate = program.schedule.rate(step)
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
        _sync(device)
        t0 = time.perf_counter()
        params, opt_state, metrics = fn(params, opt_state, batch)
        loss = metrics["loss"].item()  # waits for the step
        _sync(device)
        dt = time.perf_counter() - t0
        history.append(loss)
        aux.append(float(metrics["aux"]))
        rates.append(rate)
        step_times.append(dt)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} rate={rate:.2f} loss={loss:.4f} aux={aux[-1]:.4f} "
                  f"({dt * 1e3:.0f} ms)")
    return {
        "history": history,
        "aux": aux,
        "final_loss": history[-1] if history else None,
        "rates": rates,
        "step_times": step_times,
        "launches": {k: gm.launches[k] - before[k] for k in gm.launches},
    }


def main():
    args = build_parser().parse_args()
    out = run(args)
    if out["final_loss"] is None:
        print("[train] nothing to do: --steps 0")
    else:
        print(f"[train] done. final loss {out['final_loss']:.4f}")
    print("[train] kernel launches:", out["launches"])


if __name__ == "__main__":
    main()
