"""How far the SSM's routes part with depth: mamba2-1.3b's ``A_log``.

``chip_smoke.py``'s ``[ssm-route]`` holds one sparse training step of
mamba2-1.3b (full width, depth 4, fp32, TF32 off, B=2, S=512,
``paper_default(0.8)``) to the same step on the other routes: the loss
and every gradient leaf within a relative L2 of 1e-4 (``TRAIN_ROUTE_TOL``
there). Its closest leaf is a layer's ``A_log``. This tool takes the
same step at more depths (8 and 48 by default) on the three routes
(``matmul``: the shrunk products through the hand-written kernel;
``gather``: the same products in plain PyTorch; ``mask``: the
full-size oracle), checks that every site keeps the same channels on
all three, and reports each pair's worst relative L2 over every leaf
and over the ``A_log`` leaves alone (with the layer), against the gate.
Exits 1 where a leaf crosses the gate.

Run on the card from the repo root:
``PYTHONPATH=src python tools/ssm_route_depth.py --out chiprun_out/ssm_route_depth.json``
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ARCH, BATCH, SEQ, RATE = "mamba2-1.3b", 2, 512, 0.8
GATE = 1e-4  # chip_smoke.py's TRAIN_ROUTE_TOL


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _rel(a, b) -> float:
    n = b.float().norm().item()
    d = (a.float() - b.float()).norm().item()
    return d / n if n > 0 else d


def depth_check(depth: int) -> dict:
    """One sparse step of mamba2-1.3b cut to ``depth`` layers on the three
    routes: the kept channels, the losses and the worst leaves."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import backward
    from repro_torch.core import policy as policy_mod
    from repro_torch.data.pipeline import TokenPipeline, TokenPipelineConfig
    from repro_torch.launch import steps
    from repro_torch.models import model as lm

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=depth, dtype="float32")
    params = lm.init_params(cfg, 0, device="cuda")
    pipe = TokenPipeline(TokenPipelineConfig(cfg.vocab, SEQ, BATCH, 0))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(0).items()}
    kern = dataclasses.replace(policy_mod.paper_default(RATE), use_pallas=True)
    routes = {"matmul": kern, "gather": dataclasses.replace(kern, use_pallas=False),
              "mask": dataclasses.replace(kern, use_pallas=False, mask_mode=True)}
    res = {}
    for name, pol in routes.items():
        with backward.record_selections() as log:
            (loss, _), grads = steps.value_and_grad(
                lambda p, pol=pol: lm.loss_fn(cfg, p, batch, pol), params)
        torch.cuda.synchronize()
        res[name] = (loss.item(), _leaves(grads), [s.idx.cpu() for _, s in log])
        del grads
    out = {"depth": depth, "loss": {k: v[0] for k, v in res.items()}, "pairs": {}}
    for a, c in (("matmul", "gather"), ("matmul", "mask"), ("gather", "mask")):
        same = len(res[a][2]) == len(res[c][2]) and all(
            torch.equal(x, y) for x, y in zip(res[a][2], res[c][2], strict=True))
        rels = [(path, _rel(ga, gb)) for (path, ga), (_, gb) in
                zip(res[a][1], res[c][1], strict=True)]
        worst = max(rels, key=lambda r: r[1])
        a_log = max((r for r in rels if r[0].endswith("A_log")), key=lambda r: r[1])
        out["pairs"][f"{a}_vs_{c}"] = dict(
            same_kept=same, worst_leaf=worst[0], worst_rel=worst[1], a_log_leaf=a_log[0],
            a_log_rel=a_log[1], over_gate=[p for p, r in rels if r > GATE])
    out["seconds"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="8,48")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssm_route_depth: CUDA is not available; this tool runs on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[ssm-route-depth] {card}")
    from repro_torch.kernels import build

    build.build_all()
    rows, ok = [], True
    for depth in (int(d) for d in args.depths.split(",")):
        r = depth_check(depth)
        rows.append(r)
        for pair, p in r["pairs"].items():
            ok &= p["same_kept"] and not p["over_gate"]
            print(f"[ssm-route-depth] depth {depth} {pair}: kept sets equal {p['same_kept']}; "
                  f"worst leaf {p['worst_leaf']} {p['worst_rel']:.4e}; A_log worst "
                  f"{p['a_log_leaf']} {p['a_log_rel']:.4e} (gate {GATE}); over the gate "
                  f"{p['over_gate']}")
        print(f"[ssm-route-depth] depth {depth}: losses {r['loss']} in {r['seconds']:.1f} s",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "gate": GATE, "rows": rows}, f, indent=1)
    print(json.dumps({"ok": ok, "depths": [r["depth"] for r in rows]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
