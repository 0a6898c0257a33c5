"""Generation CLI: train the DDPM UNet, dense vs ssProp (2-epoch bar), then sample.

The port's counterpart of the JAX package's ``examples/ddpm_generation.py``,
with its flags and defaults (AdamW, epsilon MSE, the linear beta
schedule, the epoch-bar schedule at 0.8, 4 samples over the whole
schedule written as ``.npy`` to ``--out``), plus:

  * ``--channels``, ``--base``, ``--t-dim``: the UNet's
    ``init_params`` arguments (defaults: the example's 1, 16, 64; the
    paper's CelebA task is ``--channels 3 --size 64 --timesteps 1000
    --base 64 --t-dim 256 --batch 128``);
  * ``--device`` (default ``cuda``; asking for ``cuda`` without a card
    raises: there is no fall-back to the CPU);
  * ``--mode {dense,ssprop,both}`` (default ``both``, as the example runs
    both);
  * ``--granularity``, ``--block-size``, ``--use-pallas``: the
    ``SsPropPolicy`` fields that pick the backward route, as in
    ``train_classifier``. ``--granularity block --block-size 32
    --use-pallas`` trains through the gathered CUDA kernels with blocks
    really dropped at the UNet's 64- and 128-channel sites.

Data: the synthetic image stream (``ImagePipeline`` at ``(channels,
size, size)``, labels unused). Each step draws its timesteps and noise
from a ``torch.Generator``, runs the forward pass, the channel-sparse
backward and a functional AdamW update, in fp32 with TF32 off. At the
end the CLI prints the backward-FLOPs ledger.

  PYTHONPATH=src python -m repro_torch.launch.train_ddpm --channels 3 --size 64 \\
      --timesteps 1000 --base 64 --t-dim 256 --batch 128 --steps 8 \\
      --steps-per-epoch 2 --granularity block --block-size 32 --use-pallas --mode ssprop
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.schedulers import drop_rate_for_step
from repro_torch.data.pipeline import ImagePipeline, ImagePipelineConfig
from repro_torch.kernels import gathered_matmul as gm
from repro_torch.launch import steps
from repro_torch.launch.precision import fp32_precision
from repro_torch.launch.train_classifier import flops_ledger, print_ledger, step_policy
from repro_torch.models import ddpm
from repro_torch.optim import adam

TARGET = 0.8  # the example's epoch-bar drop rate
N_SAMPLES = 4


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--steps-per-epoch", type=int, default=40)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--timesteps", type=int, default=100)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "ddpm_samples.npy"),
                    help="where the samples go (.npy); empty: not written")
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--base", type=int, default=16)
    ap.add_argument("--t-dim", type=int, default=64)
    ap.add_argument("--mode", choices=("dense", "ssprop", "both"), default="both")
    ap.add_argument("--granularity", choices=("channel", "block"), default="channel")
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--use-pallas", action=argparse.BooleanOptionalAction, default=False,
                    help="shrunk backward contractions through the gathered CUDA kernels "
                    "(the SsPropPolicy field's name is the JAX package's)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def value_and_grad(params, sched, x0, t, noise, policy):
    """(loss, grads), grads a tree like ``params``."""
    (loss, _), grads = steps.value_and_grad(
        lambda p: (ddpm.loss_fn(p, sched, x0, t, noise, policy), {}), params)
    return loss, grads


def train_step(params, opt, sched, x0, t, noise, policy, ocfg: adam.AdamConfig):
    """One step: forward, channel-sparse backward, AdamW. Returns
    (params, opt, loss)."""
    loss, grads = value_and_grad(params, sched, x0, t, noise, policy)
    params, opt, _ = adam.apply_updates(ocfg, params, grads, opt)
    return params, opt, loss


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """Train each mode from the same init, in full fp32 (TF32 off, as the
    JAX package computes), then sample from the last mode trained.
    Returns per mode the losses, the drop rate and wall time of every
    step (the step ends in a device sync); the launches of each gathered
    kernel over the training steps; the samples and the wall time of
    sampling them; the TF32 flags that were in force; and the
    backward-FLOPs ledger
    (:func:`~repro_torch.launch.train_classifier.flops_ledger`)."""
    with fp32_precision() as tf32:
        out = _train(args)
    image = (args.channels, args.size, args.size)
    led = flops_ledger(
        lambda **kw: ddpm.flops_per_iter(args.batch, image, args.base, **kw), args, TARGET)
    return {**out, "tf32": tf32, "flops": led}


def _train(args) -> dict:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available (pass --device cpu)")
    image = (args.channels, args.size, args.size)
    pipe = ImagePipeline(ImagePipelineConfig(image, 10, args.batch, seed=11), n_train=1024)
    sched = ddpm.make_schedule(args.timesteps, device=device)
    ocfg = adam.adamw()
    modes = ("dense", "ssprop") if args.mode == "both" else (args.mode,)
    before = dict(gm.launches)
    out = {}
    for mode in modes:
        params = ddpm.init_params(0, channels=args.channels, base=args.base, t_dim=args.t_dim,
                                  device=device)
        opt = adam.init(params)
        gen = torch.Generator(device=device).manual_seed(1)
        rec = {"losses": [], "rates": [], "step_times": []}
        for i in range(args.steps):
            rate = 0.0 if mode == "dense" else drop_rate_for_step(
                "epoch_bar", step=i, steps_per_epoch=args.steps_per_epoch,
                total_steps=args.steps, target=TARGET,
            )
            x0 = torch.from_numpy(pipe.batch_at(i)["images"]).to(device)
            t, noise = ddpm.draw_t_noise(gen, x0, args.timesteps)
            _sync(device)
            t0 = time.perf_counter()
            params, opt, loss = train_step(params, opt, sched, x0, t, noise,
                                           step_policy(args, rate), ocfg)
            _sync(device)
            rec["step_times"].append(time.perf_counter() - t0)
            rec["losses"].append(loss.item())
            rec["rates"].append(rate)
        out[mode] = rec
    launches = {k: gm.launches[k] - before[k] for k in gm.launches}
    gen = torch.Generator(device=device).manual_seed(42)
    shape = (N_SAMPLES, *image)
    x_t = torch.randn(shape, generator=gen, device=device)
    t0 = time.perf_counter()
    samples = ddpm.sample(params, sched, x_t,
                          lambda i: torch.randn(shape, generator=gen, device=device)).cpu()
    return {"modes": out, "launches": launches, "sampled_from": modes[-1],
            "samples": samples.numpy(), "sample_s": time.perf_counter() - t0}


def main():
    args = build_parser().parse_args()
    res = run(args)
    for mode, rec in res["modes"].items():
        spe = args.steps_per_epoch
        for i in range(spe - 1, len(rec["losses"]), spe):
            print(f"[{mode}] step {i + 1:4d} loss={rec['losses'][i]:.4f}")
        print(f"{mode:7s} steps={len(rec['losses'])} wall={sum(rec['step_times']):.1f}s")
    print("[train] gathered-kernel launches:", res["launches"])
    s = res["samples"]
    if args.out:
        np.save(args.out, s)
        print(f"[{res['sampled_from']}] wrote {args.out} "
              f"(range [{float(s.min()):.2f}, {float(s.max()):.2f}])")
    print_ledger(res["flops"], args)


if __name__ == "__main__":
    main()
