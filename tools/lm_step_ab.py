"""The qwen2.5-3b training step of two or more source trees on one card.

Each tree (a checkout holding ``src/`` and ``chip_smoke.py``) runs in a
process of its own, in the order A, B, ..., B, A: its ``matmul`` kernel
built from its sources, then its ``chip_smoke.py``'s
``lm_training_phase`` (the training CLI's 8 epoch-bar steps at full
width and depth, B=8 S=128, counted; its peak memory) and ``lm_profile``
(one dense and one sparse step after a warm-up: host wall and device
busy), then one more profiled dense step whose device kernels, by name
(count, ms), it writes to ``chiprun_out/lm_kernels_<tree>_<run>.json``.
A process prints one ``RESULT`` JSON line; this script prints the
card's name and power limit, then one JSON line a run.

Run on the card from the repo root, the parent commit unpacked into a
git-ignored directory (``git archive HEAD~1 | tar -x -C build/parent``):
``python3 tools/lm_step_ab.py build/parent .``
"""
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, sys
import torch
import torch.profiler
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from repro_torch.configs.registry import get_config
from repro_torch.core import policy as policy_mod
from repro_torch.data import pipeline
from repro_torch.kernels import build
from repro_torch.kernels import gathered_matmul as gm
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import steps, train
from repro_torch.models import model as lm
from repro_torch.optim import adam

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.build_all(["matmul"])
cfg = get_config(cs.LM_ARCH)
_, ms = cs.lm_training_phase(train, lm, gm, pa, policy_mod, cfg)
peak = torch.cuda.max_memory_allocated()
prof, (params, opt, batch) = cs.lm_profile(lm, steps, adam, policy_mod, pipeline, cfg)
fn = steps.make_train_step(cfg, policy_mod.DENSE, adam.AdamConfig(lr=2e-4, clip_norm=1.0))
with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
    fn(params, opt, batch)[2]["loss"].item()
kernels = {e.key: [e.count, e.self_device_time_total / 1e3] for e in p.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA}
with open(sys.argv[2], "w") as f:
    json.dump(kernels, f, indent=0, sort_keys=True)
print("RESULT " + json.dumps({"step_ms": ms, "peak_gib": peak / 2**30, "profile": prof}))
"""


def run(tree: Path, dump: Path) -> dict:
    res = subprocess.run([sys.executable, "-c", RUN, str(tree), str(dump)], cwd=tree,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"{tree}: exit {res.returncode}\n{res.stdout[-3000:]}\n"
                           f"{res.stderr[-3000:]}")
    line = next(x for x in res.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    trees = [(chr(ord("A") + i), Path(p).resolve()) for i, p in enumerate(sys.argv[1:])]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    out_dir = Path("chiprun_out").resolve()
    out_dir.mkdir(exist_ok=True)
    for i, (name, tree) in enumerate(trees + trees[::-1]):
        out = run(tree, out_dir / f"lm_kernels_{name}_{i}.json")
        print(json.dumps({"tree": name, "path": str(tree), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
