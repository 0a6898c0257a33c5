"""Where ``[mesh-families]``' kept sets leave the one-device run's.

Trains paligemma-3b (depth 4) and mamba2-1.3b (depth 8) as
``chip_smoke.py``'s ``[mesh-families]`` does (full width, fp32, TF32
off, ``paper_default(0.8)`` with ``--use-pallas``, 3 steps: dense,
sparse, sparse): 1x1 twice in this process (is the step deterministic?)
and 1x2 in two spawned ranks on the card, and prints, for the second 1x1
run and for 1x2, the share of (step, site) kept sets equal to the first
1x1 run's and the sets that swap most channels. ``PROBE_EPS`` (the
environment, so that the spawned ranks see it too) sets Adam's eps for
every run (the CLI's is 1e-8): where a gradient is below eps Adam moves
an element by ``lr * g / eps``, so raising eps shows whether that regime
parts the runs. Writes ``chiprun_out/probe_families_<eps>.json``.

Run on the card from the repo root:
``python3 tools/mesh_family_probe.py; PROBE_EPS=1e-5 python3 tools/mesh_family_probe.py``
"""
import dataclasses, json, os, sys, time
sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "src")]
import torch
from repro_torch.optim import adam

_EPS = float(os.environ.get("PROBE_EPS", "0"))
if _EPS:
    _raw = adam.apply_updates
    adam.apply_updates = lambda cfg, *a, **k: _raw(dataclasses.replace(cfg, eps=_EPS), *a, **k)


def rank(mesh, argv, cfg):
    from repro_torch.launch import train
    torch.backends.cuda.matmul.allow_tf32 = False
    return train.run_rank(mesh, train.build_parser().parse_args(argv), cfg, ("kept",))


def compare(a, b):
    sites = [(st, si) for st in a["kept"] for si in a["kept"][st]]
    diff = {f"{st} {si}": (len(set(b["kept"][st].get(si, ())) - set(a["kept"][st][si])),
                           len(a["kept"][st][si]))
            for st, si in sites if b["kept"][st].get(si) != a["kept"][st][si]}
    return sum(1 for s in sites if f"{s[0]} {s[1]}" not in diff) / len(sites), diff


def main():
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.launch.mesh import run_on_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    print(cs.smi(), flush=True)
    eps = os.environ.get("PROBE_EPS", "")
    out = {}
    for arch in (cs.VLM_ARCH, cs.SSM_ARCH):
        cut, b, sq = cs.MF_TRAIN[arch]
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
        argv = train.build_parser().parse_args(cs._mf_train_argv(arch, b, sq, 1, 1))
        one = train.run(argv, cfg=cfg, collect=("kept",))
        again = train.run(argv, cfg=cfg, collect=("kept",))
        m12 = run_on_mesh(rank, 1, 2, "cuda", cs._mf_train_argv(arch, b, sq, 1, 2), cfg,
                          timeout_s=300)
        for name, o in (("1x1 again", again), ("1x2", m12)):
            share, diff = compare(one, o)
            worst = sorted(diff.items(), key=lambda kv: -kv[1][0])[:6]
            print(f"[probe] eps={eps or '1e-8'} {arch} {name}: kept sets equal {share:.4f}; "
                  f"losses {o['history']} vs {one['history']}; swapped {worst}", flush=True)
            out[f"{arch} {name}"] = dict(share=share, diff=diff)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/probe_families_{eps or '1e-8'}.json", "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
