"""Static checks of the CUDA kernels' launches over ``kernels/specs.py``
(twin of ``repro.analysis.pallas_check``).

A spec describes one launch as the kernel's ``<name>_launch`` makes it
(``chip_smoke.py``'s ``[audit]`` holds the two equal on the card); these
checks then hold for the launched kernel:

* **in bounds** — every block of the grid, swept whole, writes a tile
  whose origin lies inside the output, loads only ``block_idx`` entries
  that exist, and every block index (a kept channel block, a page) names
  a real block of its operand; without the block indices, at their
  extreme legal values (every kernel's addressing is monotone in them);
* **ragged tails** — the shapes the wrapper hands the kernel (its padding:
  ``ops._dy_rows``' channel pad to whole blocks, the padded image) are the
  shapes the kernel assumes, and the spec's contract holds (whole blocks
  a group, ``C_pad`` a multiple of the block);
* **shared memory** — every launch's dynamic plus static shared memory
  within a limit given as a parameter (:data:`SM90_OPTIN_SMEM` by
  default; ``chip_smoke.py`` passes the card's own
  ``shared_memory_per_block_optin``);
* **traffic** — the tile schedule's bytes (``specs.emulate_bytes``, the
  grid swept) against the least bytes (each input read once, each output
  written once): below it is impossible and errors, the ratio is
  reported.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.report import ERROR, INFO, Report
from repro_torch.core.policy import SsPropPolicy
from repro_torch.kernels import gathered_matmul as gm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import specs

#: the most shared memory one block may opt in to on compute capability
#: 9.0 (227 KB: the CUDA C++ Programming Guide's table of technical
#: specifications per compute capability)
SM90_OPTIN_SMEM = 227 * 1024

#: grids larger than this are not swept for traffic (the report says so)
MAX_EMULATED_BLOCKS = 1 << 18


def check_in_bounds(report: Report, spec: specs.KernelSpec, block_idx=None) -> bool:
    """Sweep the main launch's grid: each tile's origin inside the output,
    each ``block_idx`` entry it loads present, each block index value a
    real block. Returns whether it held."""
    where = spec.name
    idx = block_idx if block_idx is not None else spec.block_idx
    n_idx = spec.operands["block_idx"][0][0] if "block_idx" in spec.operands else None
    if idx is not None:
        bad = [b for b in idx if not 0 <= b < spec.n_blocks]
        if bad:
            report.add("launch", ERROR, f"{where}/block_idx",
                       f"block index {bad[0]} out of bounds: the operand has {spec.n_blocks} "
                       "block(s)", block_index=bad[0], limit=spec.n_blocks)
            return False
        if spec.groups > 1 and spec.n_blocks % spec.groups == 0:
            per = spec.n_blocks // spec.groups
            if any(b // per >= spec.groups for b in idx):
                report.add("launch", ERROR, f"{where}/block_idx",
                           "a block index past the last group")
                return False
    n_tiles = 0
    for t in spec.tiles():
        n_tiles += 1
        out_of = [i for i, (o, e) in enumerate(zip(t.origin, spec.output, strict=True))
                  if not 0 <= o < e]
        if out_of:
            report.add("launch", ERROR, f"{where}/tile",
                       f"block {t.point} writes from {t.origin}, outside the output "
                       f"{spec.output}", grid_point=list(t.point), origin=list(t.origin),
                       limit=list(spec.output))
            return False
        if n_idx is not None and t.loads and max(t.loads) >= n_idx:
            report.add("launch", ERROR, f"{where}/block_idx",
                       f"block {t.point} loads block_idx[{max(t.loads)}] of {n_idx}",
                       grid_point=list(t.point))
            return False
    report.add("launch", INFO, where, f"in bounds over {n_tiles} block(s)",
               blocks=n_tiles, grid=[list(ln.grid) for ln in spec.launches])
    return True


def check_ragged(report: Report, spec: specs.KernelSpec, passed: dict | None = None) -> bool:
    """The wrapper's operand shapes (``passed``: name -> shape) are the
    kernel's, and the spec's contract holds."""
    ok = True
    for name, holds in spec.contract.items():
        if not holds:
            ok = False
            report.add("launch", ERROR, f"{spec.name}/contract",
                       f"ragged operand: {name} does not hold", contract=name)
    for name, shape in (passed or {}).items():
        want = spec.operands[name][0]
        if tuple(shape) != tuple(want):
            ok = False
            report.add("launch", ERROR, f"{spec.name}/{name}",
                       f"the wrapper passes {tuple(shape)}, the kernel assumes {tuple(want)}",
                       passed=list(shape), assumed=list(want))
    return ok


def check_smem(report: Report, spec: specs.KernelSpec, *, limit: int = SM90_OPTIN_SMEM,
               label: str = "the sm_90 opt-in limit") -> bool:
    """Every launch's shared memory within ``limit`` bytes."""
    used = spec.shared_bytes
    report.add("launch", ERROR if used > limit else INFO, spec.name,
               f"shared memory {used:,} B a block vs {label} {limit:,} B",
               shared_bytes=used, limit=limit)
    return used <= limit


def check_traffic(report: Report, spec: specs.KernelSpec) -> float | None:
    """Emulated bytes against the least bytes; returns their ratio (None
    where the grid is too large to sweep)."""
    blocks = spec.launches[0].blocks if spec.launches else 0
    if blocks > MAX_EMULATED_BLOCKS:
        report.add("launch", INFO, spec.name, f"traffic not emulated: {blocks} blocks")
        return None
    moved, least = specs.emulate_bytes(spec), spec.least_bytes
    ratio = moved / least if least else 0.0
    report.add("launch", ERROR if moved < least else INFO, spec.name,
               f"tile schedule moves {moved:,} B, the least is {least:,} B ({ratio:.2f}x)",
               emulated_bytes=moved, least_bytes=least, ratio=ratio)
    return ratio


def check_spec(report: Report, spec: specs.KernelSpec, *, limit: int = SM90_OPTIN_SMEM,
               label: str = "the sm_90 opt-in limit", block_idx=None, passed=None,
               traffic: bool = True) -> bool:
    """Every check on one launch; True where none errored."""
    n = len(report.errors())
    check_ragged(report, spec, passed)
    if block_idx is None and spec.block_idx is None and spec.n_blocks:
        # the extreme legal block indices: all first blocks, all last blocks
        table = spec.operands.get("block_idx", spec.operands.get("block_tables"))[0]
        kb = table[0] if len(table) == 1 else table[0] * table[1]
        for cand in ((0,) * kb, (spec.n_blocks - 1,) * kb):
            check_in_bounds(report, spec, cand)
    else:
        check_in_bounds(report, spec, block_idx)
    check_smem(report, spec, limit=limit, label=label)
    if traffic:
        check_traffic(report, spec)
    return len(report.errors()) == n


# ----------------------------------------------------------------------
# per-site audits
# ----------------------------------------------------------------------


def balanced_blocks(nb: int, kb: int, groups: int) -> list[int]:
    """Sorted kept blocks covering the groups evenly (what the engine's
    per-group top-k keeps)."""
    bpg = nb // groups
    per_g = max(kb // groups, 1)
    return sorted(g * bpg + i for g in range(groups) for i in range(per_g))[:kb]


def conv_fused_site_specs(bt: int, h_out: int, w_out: int, c_in: int, c_out: int, k: int,
                          policy: SsPropPolicy, *, groups: int = 1, bf16: bool = False):
    """The (dW, dX) fused-kernel specs of one conv site at the auditor's
    stride-1 probe geometry, the balanced kept blocks, and the shapes the
    wrapper (``kernels/ops.py``) passes the two kernels."""
    bs = policy.block_size
    c_pad = c_out + (-c_out) % bs
    nb = c_pad // bs
    kb = policy.keep_count(c_out)
    blocks = balanced_blocks(nb, kb, groups)
    cg = c_in // groups
    pad = ((k - 1) // 2, (k - 1) - (k - 1) // 2)
    h_pad, w_pad = h_out + k - 1, w_out + k - 1
    s, chunk = gm.conv_dw_plan(bt * h_out * w_out, k * k * cg, kb, bs, c_out)
    dw_spec = specs.conv_dw_fused_spec(bt, h_pad, groups, w_pad, cg, h_out, w_out, c_pad, c_out,
                                       k, k, 1, 1, 1, 1, kb, bs, s, chunk, int(bf16),
                                       block_idx=blocks)
    dx_spec = specs.conv_dx_fused_spec(bt, h_out, w_out, pad[0], pad[0], groups, cg, h_out,
                                       w_out, c_pad, c_out, k, k, 1, 1, 1, 1, kb, bs, int(bf16),
                                       block_idx=blocks)
    dt = torch.bfloat16 if bf16 else torch.float32
    x = torch.empty((bt, c_in, h_out, w_out), dtype=dt, device="meta")
    dy = torch.empty((bt, c_out, h_out, w_out), dtype=dt, device="meta")
    passed = {"xg": tuple(ops._image_rows(x, (pad, pad), groups).shape),
              "dy2r": tuple(ops._dy_rows(dy, bs).shape)}
    return dw_spec, dx_spec, blocks, passed


def check_conv_fused_site(report: Report, site: str, bt: int, h_out: int, w_out: int,
                          c_in: int, c_out: int, k: int, policy: SsPropPolicy, *,
                          groups: int = 1, limit: int = SM90_OPTIN_SMEM) -> None:
    """Every launch check on one fused conv site's two kernels."""
    dw_spec, dx_spec, _, passed = conv_fused_site_specs(bt, h_out, w_out, c_in, c_out, k, policy,
                                                         groups=groups)
    check_spec(report, dw_spec, limit=limit, passed=passed)
    check_spec(report, dx_spec, limit=limit, passed={"dy2r": passed["dy2r"]})
    report.add("launch", INFO, site, "fused conv kernels checked",
               tile_flops=dw_spec.tile_flops + dx_spec.tile_flops,
               product_flops=dw_spec.product_flops + dx_spec.product_flops)


def check_gathered_site(report: Report, site: str, m: int, d_in: int, c_out: int,
                        policy: SsPropPolicy, *, limit: int = SM90_OPTIN_SMEM) -> None:
    """The canonical route's ``dx_gathered`` / ``dw_gathered`` (or the
    channel route's ``matmul`` products) at one site's 2-D shapes."""
    kb = policy.keep_count(c_out)
    if policy.granularity == "block":
        bs = policy.block_size
        blocks = balanced_blocks(-(-c_out // bs), kb, 1)
        s, chunk = gm.dw_plan(m, d_in, kb, bs, c_out)
        check_spec(report, specs.dx_gathered_spec(m, c_out, d_in, kb, bs, 0, block_idx=blocks),
                   limit=limit)
        check_spec(report, specs.dw_gathered_spec(m, d_in, c_out, kb, bs, s, chunk, 0,
                                                  block_idx=blocks), limit=limit)
        return
    for a, b in (((m, kb), (kb, d_in)), ((d_in, m), (m, kb))):
        s, chunk = gm.matmul_plan(a[0], b[1], a[1])
        check_spec(report, specs.matmul_spec(a[0], b[1], a[1], a[1], 1, b[1], 1, s, chunk, 1),
                   limit=limit)


def check_paged_attention_site(report: Report, *, b: int, s: int, h: int, d: int, n_pages: int,
                               bs_pg: int, kvh: int, nb: int, bf16: bool = False,
                               limit: int = SM90_OPTIN_SMEM) -> None:
    """The paged-attention launch of one serve configuration, its split
    plan the wrapper's."""
    plan = pa.paged_split_plan(b, s, h, kvh, d, nb, bs_pg)
    spec = specs.paged_attention_spec(b, s, h, kvh, d, n_pages, bs_pg, nb, plan.row_tile,
                                      plan.chunk, plan.splits, int(bf16), int(bf16))
    check_spec(report, spec, limit=limit)
