"""Where a sequence-split run's kept channels leave the one-device run's.

Trains one of ``chip_smoke.py``'s ``[mesh-seq]`` family configs (default
paligemma-3b: full width, 2 of 18 layers, fp32, TF32 off,
``paper_default(0.8)`` with ``--use-pallas``, 3 steps, B=1 S=128) at 1x1
in this process and on ``--data-mesh 2`` in two spawned ranks on the
card, records the importance vector of every selection (after the mean
over the data ranks) and prints, selection by selection in backward
order: the kept channels 2x1 swaps against 1x1, the relative gap at 1x1's
boundary (the k-th largest importance against the next) and the largest
relative difference between the two importance vectors. A swap where the
gap is below the difference is a near tie the two layouts' rounding
decides.

Environment (read by the spawned ranks too): ``PROBE_EPS`` sets Adam's
eps (the CLI's is 1e-8); ``PROBE_SCHED`` the ``--scheduler`` (default
``bar``: a dense first step; ``constant``: every step sparse);
``PROBE_BATCH`` the global batch (2 puts ``data`` on the batch instead of
the sequence); ``PROBE_ARCHS`` a comma-separated list of
``chip_smoke.MF_SEQ`` archs.

Run on the card from the repo root:
``python3 tools/seq_split_tie_probe.py; PROBE_EPS=1e-5 python3 tools/seq_split_tie_probe.py``
"""
import dataclasses
import gc
import json
import os
import sys

sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LOG = []  # (site, importance, kept channels, k) of every selection, in order


def patch():
    """Record every selection's importance; set Adam's eps from the environment."""
    from repro_torch.core import backward, sparsity
    from repro_torch.optim import adam

    eps = float(os.environ.get("PROBE_EPS", "0"))
    if eps and not getattr(adam, "_probe_eps", False):
        raw_update = adam.apply_updates
        adam.apply_updates = lambda cfg, *a, **k: raw_update(dataclasses.replace(cfg, eps=eps),
                                                             *a, **k)
        adam._probe_eps = True
    if getattr(sparsity, "_probe_log", False):
        return
    raw = sparsity.select_from_importance

    def logged(imp, policy, **kw):
        sel = raw(imp, policy, **kw)
        region = backward.current_region()
        LOG.append((region[0] if region else backward.current_scope(),
                    imp.detach().float().cpu(), sel.idx.detach().cpu(), sel.k))
        return sel

    sparsity.select_from_importance = logged
    sparsity._probe_log = True


def rank_body(mesh, argv, cfg):
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    patch()
    return train.run_rank(mesh, train.build_parser().parse_args(argv), cfg, ("kept",)), LOG


def compare(one_log, mesh_log):
    rows = []
    for (site, i1, x1, k), (_, i2, x2, _) in zip(one_log, mesh_log, strict=True):
        top = torch.sort(i1, descending=True).values
        gap = float((top[k - 1] - top[k]) / top[k - 1]) if k < len(top) else float("nan")
        diff = float(((i1 - i2).abs() / i1.abs().clamp_min(1e-30)).max())
        rows.append(dict(site=site, k=k, n=len(i1), swapped=len(set(x1.tolist()) - set(x2.tolist())),
                         gap_rel=gap, imp_rel_diff=diff))
    return rows


def argv_of(arch, b, sq, data):
    return cs._mf_train_argv(arch, b, sq, data, 1, os.environ.get("PROBE_SCHED", "bar"))


def main():
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.launch.mesh import run_on_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    print(cs.smi(), flush=True)
    tag = (f"eps={os.environ.get('PROBE_EPS', '1e-8')} "
           f"sched={os.environ.get('PROBE_SCHED', 'bar')}")
    for arch in os.environ.get("PROBE_ARCHS", cs.VLM_ARCH).split(","):
        _, b, sq, cfg = cs.mf_seq_cases(get_config)[arch]
        b = int(os.environ.get("PROBE_BATCH", b))
        patch()
        LOG.clear()
        one = train.run(train.build_parser().parse_args(argv_of(arch, b, sq, 1)), cfg=cfg,
                        collect=("kept",))
        one_log = list(LOG)
        LOG.clear()
        gc.collect()
        torch.cuda.empty_cache()
        out, mesh_log = run_on_mesh(rank_body, 2, 1, "cuda", argv_of(arch, b, sq, 2), cfg,
                                    timeout_s=400)
        rel = max(abs(x - y) / abs(y) for x, y in zip(out["history"], one["history"], strict=True))
        rows = compare(one_log, mesh_log)
        print(f"[probe] {tag} {arch} B={b}: 1x1 losses {one['history']}, 2x1 {out['history']} "
              f"(max rel {rel:.3g}); selections with swaps {sum(r['swapped'] > 0 for r in rows)} "
              f"of {len(rows)}", flush=True)
        for r in rows:
            print(f"[probe] {tag} {arch} B={b}", json.dumps(r), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
