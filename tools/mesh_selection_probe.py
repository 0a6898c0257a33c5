"""Where a mesh run's kept channels leave the one-device run's.

Trains qwen2.5-3b at full width, depth 4, fp32 with TF32 off, B=8 S=128,
``paper_default(0.8)`` with ``--use-pallas``, 3 steps (dense, sparse,
sparse), as ``chip_smoke.py``'s ``[mesh-train]`` does, several ways:

* ``1x1``: ``train.run`` in this process (the one-device path), the
  reference; ``1x1 again``: the same (is the step deterministic?);
* ``1x1, rows reversed``: the one-device path with each batch's rows
  (sequences) in reverse order: the same loss and gradients, summed in
  another order;
* ``mesh 1x1``: the training CLI's rank body on a 1x1 mesh, the mesh
  path's code with no collective moving data;
* ``mesh 1x1, plain CE``: the same with ``parallel.vocab_cross_entropy``
  replaced by the one-device ``log_softmax`` cross-entropy;
* ``mesh 1x1, plain norm``: with ``parallel.global_norm`` replaced by
  ``adam.global_norm``;
* ``2x1``: two data ranks; ``1x2``: two model ranks (kept sets and
  losses only: its params are shards);
* ``1x1, eps 1e-5`` and ``2x1, eps 1e-5``: both with Adam's eps raised
  from 1e-8 to 1e-5, the second held to the first (where a gradient is
  below eps, Adam moves an element by ``lr * g / eps``: the gain on a
  gradient's rounding is ``lr / eps``, 2e4 at the CLI's defaults).

For each: the losses and the (step, site) kept sets against its
reference (``1x1`` but where named); the
embedding's and layer 0's params after steps 0 and 1 and their clipped
gradients against the reference's, leaf by leaf (the largest difference, the
elements that moved apart by more than a tenth and a half of ``lr``, the
gradients' largest difference against their largest value and the
elements whose sign differs); the importance of step 2's layer-0
attention sites against the reference's (at a swapped channel, its distance
from the k-th largest). Writes everything to ``--out`` (JSON) and prints
a summary.

Run on the card from the repo root:
``PYTHONPATH=src python tools/mesh_selection_probe.py --out chiprun_out/mesh_probe.json``
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile

import torch

ARCH, DEPTH, BATCH, SEQ, RATE, STEPS = "qwen2.5-3b", 4, 8, 128, 0.8, 3
LAYER0 = ("layer_0/attn/q", "layer_0/attn/k", "layer_0/attn/v", "layer_0/attn/o")
SNAP_LEAVES = ("embed/", "layer_0/")  # the leaves compared after steps 0 and 1
# name -> (data, model (0, 0: the one-device path in this process), variant,
# Adam's eps (None: the CLI's), the reference it is held to (None: it is one))
VARIANTS = {
    "1x1": (0, 0, "", None, None),
    "1x1 again": (0, 0, "", None, "1x1"),
    "1x1, rows reversed": (0, 0, "rows reversed", None, "1x1"),
    "mesh 1x1": (1, 1, "", None, "1x1"),
    "mesh 1x1, plain CE": (1, 1, "plain CE", None, "1x1"),
    "mesh 1x1, plain norm": (1, 1, "plain norm", None, "1x1"),
    "2x1": (2, 1, "", None, "1x1"),
    "1x2": (1, 2, "", None, "1x1"),
    "1x1, eps 1e-5": (0, 0, "", 1e-5, None),
    "2x1, eps 1e-5": (2, 1, "", 1e-5, "1x1, eps 1e-5"),
}


def _argv(data: int, model: int) -> list[str]:
    return ["--arch", ARCH, "--steps", str(STEPS), "--scheduler", "bar",
            "--global-batch", str(BATCH), "--seq-len", str(SEQ), "--drop-rate", str(RATE),
            "--granularity", "channel", "--use-pallas", "--log-every", "1", "--device", "cuda",
            "--data-mesh", str(data), "--model-mesh", str(model)]


def _cfg():
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config(ARCH), n_layers=DEPTH, dtype="float32")


def _plain_ce(logits, targets, valid, mesh):
    """The one-device path's per-token cross-entropy (``model.loss_fn``)."""
    logits = logits.float()
    if valid is not None and valid < logits.shape[-1]:
        logits = logits.clone()
        logits[..., valid:] = -1e30
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


class _Taps:
    """Records, while installed, each sparse site's importance by step
    (its site name on a mesh, ``None`` on one device) and the params and
    clipped gradients after step 1's update."""

    def __init__(self, snap_to: str | None = None, eps: float | None = None):
        self.step, self.imp, self.snap, self.norms, self.snap_to = 0, {}, {}, [], snap_to
        self.eps = eps

    def install(self, variant: str = ""):
        """Put the taps (and ``variant``'s replacement) in; returns a
        function that takes them out."""
        from repro_torch.core import sparsity
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.dist import parallel
        from repro_torch.launch import train
        from repro_torch.optim import adam

        saved = [(adam, "apply_updates"), (sparsity, "select"), (sparsity, "select_on_mesh"),
                 (parallel, "vocab_cross_entropy"), (parallel, "global_norm"),
                 (TokenPipeline, "batch_at")]
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr in saved]
        raw_apply, raw_select, raw_mesh = (v for _, _, v in saved[:3])
        raw_batch = saved[-1][2]

        def kept_leaves(tree):
            return {k: v.detach().clone() for k, v in train.named_params(tree).items()
                    if k.startswith(SNAP_LEAVES)}

        def apply(cfg, params, grads, state, **kw):
            if self.eps is not None:
                cfg = dataclasses.replace(cfg, eps=self.eps)
            out = raw_apply(cfg, params, grads, state, **kw)
            self.norms.append(float(out[2]["grad_norm"]))
            if self.step in (0, 1):
                self.snap[self.step] = {"params": kept_leaves(params), "grads": kept_leaves(grads)}
                if self.step == 1 and self.snap_to:
                    torch.save(self.snap, self.snap_to)
            self.step += 1
            return out

        def select(dy, policy, **kw):
            imp = sparsity.channel_importance(dy, kw.get("channel_axis", -1))
            self.imp.setdefault(self.step, []).append((None, imp.cpu()))
            return raw_select(dy, policy, **kw)

        def select_on_mesh(dy, policy, site_mesh, **kw):
            imp = site_mesh.data_mean(sparsity.channel_importance(dy, -1))
            self.imp.setdefault(self.step, []).append((site_mesh.site, imp.cpu()))
            return raw_mesh(dy, policy, site_mesh, **kw)

        adam.apply_updates, sparsity.select, sparsity.select_on_mesh = apply, select, select_on_mesh
        if variant == "plain CE":
            parallel.vocab_cross_entropy = _plain_ce
        if variant == "plain norm":
            parallel.global_norm = lambda tree, sharded, mesh: adam.global_norm(tree)
        if variant == "rows reversed":
            TokenPipeline.batch_at = lambda pipe, step: {
                k: v[::-1].copy() for k, v in raw_batch(pipe, step).items()}

        def remove():
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        return remove

    def layer0(self) -> dict:
        """``step -> [(site, importance list) of a layer-0 attention site,
        or (site, width) of any other]`` in backward order."""
        return {st: [(s, v.tolist() if s is None or s in LAYER0 else v.numel())
                     for s, v in lst] for st, lst in self.imp.items()}


def _rank(mesh, variant, lr, eps, ref_path):
    """One rank of a mesh variant: the CLI's rank body with the taps in;
    rank 0 compares its params after steps 0 and 1 with the reference's
    (where the ranks hold whole leaves: no model split)."""
    from repro_torch.launch import train

    taps = _Taps(eps=eps)
    taps.install(variant)
    args = train.build_parser().parse_args(_argv(mesh.data, mesh.model))
    out = train.run_rank(mesh, args, _cfg(), ("kept",))
    res = {"history": out["history"], "kept": out["kept"], "norms": taps.norms,
           "imp": taps.layer0() if mesh.model == 1 else None}
    if mesh.rank == 0 and mesh.model == 1:
        res["params"] = _leaf_diffs(taps.snap, torch.load(ref_path, map_location=mesh.device), lr)
    return res


def _leaf_diffs(snap, ref, lr) -> dict:
    """``step -> leaf -> numbers``: this run's snapshot against the
    reference's."""
    out = {}
    for step, mine in snap.items():
        rows = out[step] = {}
        for name, p in mine["params"].items():
            d = (p - ref[step]["params"][name]).abs()
            g, gr = mine["grads"][name], ref[step]["grads"][name]
            big = torch.maximum(g.abs(), gr.abs()) > 1e-8
            rows[name] = {"max_abs": float(d.max()), "gt_0.1lr": int((d > 0.1 * lr).sum()),
                          "gt_0.5lr": int((d > 0.5 * lr).sum()), "numel": p.numel(),
                          "g_max_abs_diff": float((g - gr).abs().max()),
                          "g_ref_max": float(gr.abs().max()),
                          "g_ref_median": float(gr.abs().float().median()),
                          "g_sign_flips": int(((g > 0) != (gr > 0))[big].sum())}
    return out


def _kept_diff(out, ref) -> list:
    """``[step, site, channels swapped, k, the channels in one set only]``
    where the sets differ."""
    return [[st, s, len(set(out["kept"][st][s]) ^ set(ref["kept"][st][s])) // 2,
             len(ref["kept"][st][s]), sorted(set(out["kept"][st][s]) ^ set(ref["kept"][st][s]))]
            for st in ref["kept"] for s in ref["kept"][st]
            if out["kept"][st].get(s) != ref["kept"][st][s]]


def _imp_gaps(imp, ref_imp, ref_kept, kept) -> dict:
    """At step 2's layer-0 sites: the largest relative change of any
    channel's importance, and each swapped channel's importance (the
    reference's, this run's, and the reference's distance from its k-th
    largest, relative)."""
    out = {}
    ref_at = dict(ref_imp[2])
    for site, v in imp[2]:
        if site not in LAYER0:
            continue
        v, r = torch.tensor(v), torch.tensor(ref_at[site])
        k = len(ref_kept[2][site])
        kth = float(torch.sort(r, descending=True).values[k - 1])
        swapped = sorted(set(kept[2][site]) ^ set(ref_kept[2][site]))
        out[site] = {"max_rel_change": float(((v - r).abs() / r.abs().clamp_min(1e-30)).max()),
                     "kth_ref": kth,
                     "swapped": [[c, float(r[c]), float(v[c]), (float(r[c]) - kth) / kth]
                                 for c in swapped]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/mesh_probe.json")
    ap.add_argument("--timeout", type=float, default=300.0)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mesh_selection_probe: runs on the card")
    from repro_torch.launch import train
    from repro_torch.launch.mesh import run_on_mesh

    lr = train.build_parser().parse_args(_argv(1, 1)).lr
    tmp = tempfile.mkdtemp(prefix="mesh-probe-")
    results = {}
    try:
        for name, (data, model, variant, eps, ref) in VARIANTS.items():
            path = os.path.join(tmp, f"{name if ref is None else ref}.pt")
            if (data, model) == (0, 0):  # the one-device path, in this process
                taps = _Taps(path if ref is None else None, eps)
                remove = taps.install(variant)
                try:
                    out = train.run(train.build_parser().parse_args(_argv(1, 1)), cfg=_cfg(),
                                    collect=("kept",))
                finally:
                    remove()
                results[name] = {"history": out["history"], "kept": out["kept"],
                                 "norms": taps.norms, "imp": taps.layer0()}
                if ref is not None:
                    results[name]["params"] = _leaf_diffs(
                        taps.snap, torch.load(path, map_location="cuda"), lr)
                del taps
                torch.cuda.empty_cache()
            else:
                results[name] = run_on_mesh(_rank, data, model, "cuda", variant, lr, eps, path,
                                            timeout_s=opts.timeout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the one-device runs' importance, named by the mesh run's site order
    names = {st: [s for s, _ in lst] for st, lst in results["mesh 1x1"]["imp"].items()}
    for name, (data, *_) in VARIANTS.items():
        if data == 0:
            results[name]["imp"] = {st: [(s, v) for s, (_, v) in
                                         zip(names[st], lst, strict=True) if s in LAYER0]
                                    for st, lst in results[name]["imp"].items()}
    summary = {}
    for name, out in results.items():
        ref = results[VARIANTS[name][4] or "1x1"]
        row = {"ref": VARIANTS[name][4] or "1x1",
               "loss_rel": max(abs(a - b) / abs(b) for a, b in
                               zip(out["history"], ref["history"], strict=True)),
               "norms": out["norms"], "kept_differ": _kept_diff(out, ref)}
        if out["imp"] is not None:
            row["layer0_step2"] = _imp_gaps(out["imp"], ref["imp"], ref["kept"], out["kept"])
        if "params" in out:
            row["params"] = {step: {"max_abs": max(v["max_abs"] for v in leaves.values()),
                                    "gt_0.1lr": sum(v["gt_0.1lr"] for v in leaves.values()),
                                    "gt_0.5lr": sum(v["gt_0.5lr"] for v in leaves.values()),
                                    "g_sign_flips": sum(v["g_sign_flips"] for v in leaves.values())}
                             for step, leaves in out["params"].items()}
        summary[name] = row
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump({"summary": summary, "results": results}, f)
    for name, row in summary.items():
        print(f"[probe] {name}: " + json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
