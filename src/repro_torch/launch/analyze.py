"""The program auditor's CLI (``python -m repro_torch.launch.analyze``; twin
of ``repro.launch.analyze``).

Runs the :mod:`repro_torch.analysis` checks for one config. Nothing runs
on a device: each step runs on ``meta`` tensors under the census
(``analysis/dispatch_walk.py``), and the kernels' launches are evaluated
from their specs (``kernels/specs.py``):

* **savings** — each site's backward census against the FLOPs model
  (``core/flops.py``): exact on the torch-op routes; on the kernel route
  (``--use-pallas``) the kernels' tile FLOPs beside the model's
  TPU-tiled count and their ratio, the products exact;
* **lints** — fp32 contractions inside ``bwd_dtype="bfloat16"`` regions,
  host syncs, dead contraction FLOPs (``--step-lint`` runs the whole
  train step);
* **retrace** — step-signature budgets of the policy program and
  (``--serve``) the serving engine's width ladder;
* **launch** — in-bounds, ragged-tail, shared-memory and traffic checks
  of the kernel launches the config would make.

Examples::

    python -m repro_torch.launch.analyze --arch qwen2.5-3b --reduced --serve
    python -m repro_torch.launch.analyze --model resnet18 --image 3,32,32 \\
        --batch 8 --use-pallas --granularity block
    python -m repro_torch.launch.analyze --arch mamba2-1.3b --reduced \\
        --step-lint --json report.json

Exit status is non-zero if and only if a check errored.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis import launch_check, retrace, savings
from repro_torch.analysis.dispatch_walk import Census
from repro_torch.analysis.lints import lint_step_counts
from repro_torch.analysis.report import INFO, Report
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import flops as ftab
from repro_torch.core.policy import PolicyProgram, PolicyRules, SsPropPolicy
from repro_torch.core.schedulers import make_schedule

CONV_MODELS = ("resnet18", "resnet34", "resnet50", "ddpm")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    tgt = ap.add_mutually_exclusive_group(required=True)
    tgt.add_argument("--arch", choices=ARCH_IDS, help="transformer-family config to audit")
    tgt.add_argument("--model", choices=CONV_MODELS, help="conv model to audit")
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--image", default="3,32,32", help="conv input C,H,W (with --model)")
    ap.add_argument("--batch", type=int, default=8, help="conv batch size (with --model)")
    ap.add_argument("--drop-rate", type=float, default=0.8)
    ap.add_argument("--granularity", choices=["channel", "block"], default="block")
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--use-pallas", action="store_true",
                    help="audit the kernel route (the hand-written kernels)")
    ap.add_argument("--bwd-dtype", choices=["", "bfloat16"], default="",
                    help="audit with bf16 backward contractions (and lint that no fp32 "
                    "contraction leaks in)")
    ap.add_argument("--rules", default="", help="per-site rules 'pattern=rate;...' (train.py "
                    "grammar)")
    ap.add_argument("--scheduler", default="epoch_bar")
    ap.add_argument("--step-lint", action="store_true",
                    help="run the full train step on meta and lint it (host syncs, dead FLOPs)")
    ap.add_argument("--serve", action="store_true",
                    help="audit the serve plane: retrace budget + paged attention launch")
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="KV page size for the paged-attention check")
    ap.add_argument("--smem-limit", type=int, default=launch_check.SM90_OPTIN_SMEM,
                    help="shared memory a block may take, bytes (default: the sm_90 opt-in "
                    "limit)")
    ap.add_argument("--json", default="", help="write findings JSON here")
    ap.add_argument("--verbose", action="store_true", help="render info findings too")
    return ap


def build_program(args) -> PolicyProgram:
    base = SsPropPolicy(
        drop_rate=args.drop_rate,
        target_rate=args.drop_rate,
        granularity=args.granularity,
        block_size=args.block_size,
        use_pallas=args.use_pallas,
        bwd_dtype=args.bwd_dtype,
    )
    rules = PolicyRules.parse(args.rules, base) if args.rules else PolicyRules.single(base)
    return PolicyProgram(rules=rules, schedule=make_schedule(args.scheduler,
                                                             target=args.drop_rate))


def _conv_geometries(model: str, image):
    if model == "ddpm":
        from repro_torch.models import ddpm

        return list(ddpm.iter_conv_shapes(image))
    from repro_torch.models import resnet

    return list(resnet.iter_conv_shapes(model, image))


def analyze_conv(args) -> list[Report]:
    image = tuple(int(v) for v in args.image.split(","))
    program = build_program(args)
    geoms = _conv_geometries(args.model, image)
    sites = [g[0] for g in geoms]
    table = program.resolve(sites).peak()
    sav = Report(f"savings:{args.model}")
    lau = Report(f"launch:{args.model}")
    for site, c_in, c_out, k, h_out, w_out in geoms:
        pol = table[site]
        savings.audit_conv_site(sav, site, args.batch, h_out, w_out, c_in, c_out, k, pol)
        route = ftab.conv_backward_route(pol, batch=args.batch, h_out=h_out, w_out=w_out,
                                         c_in=c_in, c_out=c_out, kh=k, kw=k)
        if route == "fused":
            launch_check.check_conv_fused_site(lau, site, args.batch, h_out, w_out, c_in, c_out,
                                               k, pol, limit=args.smem_limit)
        elif route == "canonical":
            launch_check.check_gathered_site(lau, site, args.batch * h_out * w_out,
                                             c_in * k * k, c_out, pol, limit=args.smem_limit)
    ret = Report(f"retrace:{args.model}")
    retrace.check_train_retrace(ret, program, sites)
    return [sav, lau, ret]


def analyze_lm(args) -> list[Report]:
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as lm

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    program = build_program(args)
    sites, depth = lm.site_names(cfg)
    table = program.resolve(sites, depth=depth).peak()
    reports = [savings.audit_lm(cfg, table, batch=args.global_batch, seq=args.seq_len)]
    ret = Report(f"retrace:{cfg.name}")
    retrace.check_train_retrace(ret, program, sites, depth=depth)
    if args.serve:
        from repro_torch.serve.scheduler import ServeConfig

        serve_cfg = ServeConfig(max_slots=args.global_batch, max_seq=args.seq_len,
                                prefill_chunk=args.prefill_chunk, spec_k=args.spec_k,
                                block_size=args.kv_block_size)
        retrace.check_serve_retrace(ret, cfg, serve_cfg)
        lau = Report(f"launch:{cfg.name}")
        nb = -(-args.seq_len // args.kv_block_size)
        launch_check.check_paged_attention_site(
            lau, b=args.global_batch, s=args.prefill_chunk, h=cfg.n_heads, d=cfg.head_dim,
            n_pages=args.global_batch * nb, bs_pg=args.kv_block_size, kvh=cfg.n_kv_heads, nb=nb,
            limit=args.smem_limit)
        reports.append(lau)
    reports.append(ret)

    if args.step_lint:
        from repro_torch.data.pipeline import input_specs
        from repro_torch.optim import adam

        shape = ShapeConfig("analyze", args.seq_len, args.global_batch, "train")
        fn = steps_lib.make_train_step(cfg, table, adam.AdamConfig(), accum=1)
        params, opt = steps_lib.abstract_state(cfg)
        batch = input_specs(cfg, shape)
        with Census(args=(params, opt, batch)) as c:
            out = fn(params, opt, batch)
        counts = c.finish(out)
        step = Report(f"step:{cfg.name}")
        lint_step_counts(step, "train_step", counts)
        step.add("savings", INFO, "train_step",
                 f"whole-step contraction FLOPs {counts.flops:,} (torch ops) + "
                 f"{counts.kernel_flops:,} (kernel tiles); launches {counts.launches_by_name()}",
                 flops=counts.flops, kernel_flops=counts.kernel_flops,
                 launches=counts.launches_by_name(), peak_bytes=counts.peak_bytes)
        reports.append(step)
    return reports


def main(argv=None):
    args = build_parser().parse_args(argv)
    reports = analyze_conv(args) if args.model else analyze_lm(args)
    for rep in reports:
        print(rep.render(verbose=args.verbose))
    if args.json:
        with open(args.json, "w") as f:
            json.dump([json.loads(rep.to_json()) for rep in reports], f, indent=2)
    n_err = sum(len(rep.errors()) for rep in reports)
    print(f"analyze: {n_err} error(s) across {len(reports)} report(s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
