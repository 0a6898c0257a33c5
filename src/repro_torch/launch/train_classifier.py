"""CNN training CLI: a ResNet classifier, dense vs ssProp (2-epoch bar).

The port's counterpart of the JAX package's ``examples/train_classifier.py``,
with its flags and defaults (Adam 2e-4, Kaiming init, the synthetic
image set, no augmentation), plus:

  * ``--device`` (default ``cuda``; asking for ``cuda`` without a card
    raises: there is no fall-back to the CPU);
  * ``--mode {dense,ssprop,both}`` (default ``both``, as the example runs
    both);
  * the ``SsPropPolicy`` fields that pick the backward route:
    ``--granularity``, ``--block-size``, ``--use-pallas``. Their defaults
    give the example's ``paper_default``; ``--granularity block
    --block-size 128 --use-pallas`` trains through the gathered CUDA
    kernels.

Each step runs the forward pass, the channel-sparse backward and a
functional Adam update; the epoch-bar schedule makes even epochs dense
and odd ones sparse at ``--drop-rate``.

  PYTHONPATH=src python -m repro_torch.launch.train_classifier --model resnet18 \\
      --batch 128 --image-size 32 --steps 8 --steps-per-epoch 2 \\
      --granularity block --block-size 128 --use-pallas --mode ssprop
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.nn.functional as F

from repro_torch.core.policy import SsPropPolicy, paper_default
from repro_torch.core.schedulers import drop_rate_for_step
from repro_torch.data.pipeline import ImagePipeline, ImagePipelineConfig
from repro_torch.kernels import gathered_matmul as gm
from repro_torch.launch import steps
from repro_torch.launch.precision import fp32_precision
from repro_torch.models import resnet
from repro_torch.optim import adam


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet18", choices=list(resnet.LAYOUTS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--steps-per-epoch", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--lr", type=float, default=2e-4)  # paper Table 2
    ap.add_argument("--drop-rate", type=float, default=0.8)
    ap.add_argument("--mode", choices=("dense", "ssprop", "both"), default="both")
    ap.add_argument("--granularity", choices=("channel", "block"), default="channel")
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--use-pallas", action=argparse.BooleanOptionalAction, default=False,
                    help="shrunk backward contractions through the gathered CUDA kernels "
                    "(the SsPropPolicy field's name is the JAX package's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def step_policy(args, rate: float) -> SsPropPolicy:
    """The policy of a step at drop rate ``rate``: dense at 0, else the
    example's ``paper_default`` with the route-picking fields of ``args``."""
    if rate <= 0:
        return SsPropPolicy(0.0)
    return dataclasses.replace(
        paper_default(rate), granularity=args.granularity, block_size=args.block_size,
        use_pallas=args.use_pallas,
    )


def loss_fn(name: str, params, x, y, policy: SsPropPolicy) -> torch.Tensor:
    """Mean cross-entropy of the ResNet's logits."""
    logp = F.log_softmax(resnet.forward(name, params, x, policy), dim=-1)
    return -logp[torch.arange(x.shape[0], device=x.device), y].mean()


def value_and_grad(name: str, params, x, y, policy: SsPropPolicy):
    """(loss, grads): grads is a tree like ``params``; leaves the loss
    does not reach (the BatchNorm running statistics) get zeros, as
    ``jax.value_and_grad`` gives them."""
    (loss, _), grads = steps.value_and_grad(
        lambda p: (loss_fn(name, p, x, y, policy), {}), params)
    return loss, grads


def train_step(name: str, params, opt, x, y, policy: SsPropPolicy, ocfg: adam.AdamConfig):
    """One step: forward, channel-sparse backward, Adam. Returns
    (params, opt, loss)."""
    loss, grads = value_and_grad(name, params, x, y, policy)
    params, opt, _ = adam.apply_updates(ocfg, params, grads, opt)
    return params, opt, loss


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """Train each mode from the same init, in full fp32 (TF32 off, as the
    JAX package computes). Returns per mode the losses, the drop rate and
    wall time of every step (the step ends in a device sync), and the
    eval accuracy at each epoch end; the launches of each gathered kernel
    over the whole run; and the TF32 flags that were in force."""
    with fp32_precision() as tf32:
        out = _train(args)
    return {**out, "tf32": tf32}


def _train(args) -> dict:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available (pass --device cpu)")
    image = (3, args.image_size, args.image_size)
    pipe = ImagePipeline(
        ImagePipelineConfig(image, args.classes, args.batch, seed=11), n_train=1024
    )
    ocfg = adam.AdamConfig(lr=args.lr)
    ev = pipe.eval_batch(256)
    ev_x = torch.from_numpy(ev["images"]).to(device)
    ev_y = torch.from_numpy(ev["labels"]).long().to(device)
    modes = ("dense", "ssprop") if args.mode == "both" else (args.mode,)
    before = dict(gm.launches)
    out = {}
    for mode in modes:
        params = resnet.init_params(args.model, 0, args.classes, device=device)
        opt = adam.init(params)
        rec = {"losses": [], "rates": [], "step_times": [], "eval_acc": []}
        for i in range(args.steps):
            rate = 0.0 if mode == "dense" else drop_rate_for_step(
                "epoch_bar", step=i, steps_per_epoch=args.steps_per_epoch,
                total_steps=args.steps, target=args.drop_rate,
            )
            b = pipe.batch_at(i)
            x = torch.from_numpy(b["images"]).to(device)
            y = torch.from_numpy(b["labels"]).long().to(device)
            _sync(device)
            t0 = time.perf_counter()
            params, opt, loss = train_step(
                args.model, params, opt, x, y, step_policy(args, rate), ocfg
            )
            _sync(device)
            rec["step_times"].append(time.perf_counter() - t0)
            rec["losses"].append(loss.item())
            rec["rates"].append(rate)
            if (i + 1) % args.steps_per_epoch == 0:
                with torch.no_grad():
                    logits = resnet.forward(args.model, params, ev_x, SsPropPolicy(0.0),
                                            train=False)
                rec["eval_acc"].append((logits.argmax(-1) == ev_y).float().mean().item())
        out[mode] = rec
    return {"modes": out, "launches": {k: gm.launches[k] - before[k] for k in gm.launches}}


def main():
    args = build_parser().parse_args()
    res = run(args)
    for mode, rec in res["modes"].items():
        spe = args.steps_per_epoch
        for e, acc in enumerate(rec["eval_acc"]):
            i = (e + 1) * spe - 1
            print(f"[{mode}] step {i + 1:4d} loss={rec['losses'][i]:.4f} eval_acc={acc:.3f}")
        t = sum(rec["step_times"])
        final = rec["eval_acc"][-1] if rec["eval_acc"] else float("nan")
        print(f"{mode:7s} steps={len(rec['losses'])} wall={t:.1f}s final_eval_acc={final:.3f}")
    print("[train] gathered-kernel launches:", res["launches"])


if __name__ == "__main__":
    main()
