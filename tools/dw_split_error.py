#!/usr/bin/env python3
"""Error of the dW kernels' split-K against a float64 reference, by chunk.

    python3 tools/dw_split_error.py        (on a CUDA card, from the repo root)

``conv_dw_fused`` and ``dw_gathered`` sum their reduction rows in chunks,
one chunk an accumulator (``gathered_matmul._split_plan``). The tensor
cores' fp32 accumulation truncates, so a chunk's error grows with its
length. For the DDPM UNet's longest reductions (B=128, 64x64: 524288
rows; block 32) and a ResNet-18 one (B=128, 32x32, block 128), this
prints the largest |kernel - float64| for chunk caps from none (one
wave's plan) to 1024 rows, beside the plain fp32 version's error and
the 1e-4 * max|reference| gate, fp32 and bf16 operands.
"""
from __future__ import annotations

from pathlib import Path
import subprocess
import sys

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gathered_matmul as gm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

PADS = ((1, 1), (1, 1))
# (B, C_in, C_out, H, kept blocks, block size)
CONVS = [(128, 128, 64, 64, [1], 32), (128, 64, 64, 64, [0], 32), (128, 64, 3, 64, [0], 32),
         (128, 64, 64, 32, [0], 128)]
# (M, D_in, N, kept blocks, block size)
DENSE = [(524288, 128, 64, [0], 32), (524288, 27, 64, [1], 32), (131072, 27, 64, [0], 128)]


def one_wave(rows, p, kb, block_size, c_out):
    """``conv_dw_plan`` without its chunk cap: as many splits as one wave
    of resident blocks holds, none shorter than 256 rows."""
    work = gm._cdiv(p, 64) * gm._working_col_tiles(kb, block_size, c_out)
    s = max(1, min(gm._cdiv(rows, 256), gm._SPLIT_SLOTS // max(work, 1)))
    chunk = gm._cdiv(gm._cdiv(rows, s), 32) * 32
    return gm._cdiv(rows, chunk), chunk


def capped(cap):
    """``one_wave`` with its chunks cut to ``cap`` rows (None: uncut)."""
    def plan(rows, p, kb, block_size, c_out):
        s, chunk = one_wave(rows, p, kb, block_size, c_out)
        if cap is not None and chunk > cap:
            s, chunk = gm._cdiv(rows, cap), cap
        return s, chunk
    return plan


def main() -> int:
    if not torch.cuda.is_available():
        print("dw_split_error: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    in_use = gm.conv_dw_plan
    for b, c_in, c_out, h, blocks, bs in CONVS:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((b, c_in, h, h), generator=gen, device="cuda").to(dtype)
            dy = torch.randn((b, c_out, h, h), generator=gen, device="cuda").to(dtype)
            bidx = torch.tensor(blocks, dtype=torch.int32, device="cuda")
            real = [c for bl in blocks for c in range(bl * bs, min((bl + 1) * bs, c_out))]
            ref = torch.nn.grad.conv2d_weight(x.double(), (c_out, c_in, 3, 3), dy.double(), 1, 1)
            ref = ref[real].permute(1, 2, 3, 0).reshape(c_in * 9, -1)
            plain = gm.conv_dw_fused_ref(ops._image_rows(x, PADS, 1), ops._dy_rows(dy, bs), bidx,
                                         kh_dim=3, kw_dim=3, stride=(1, 1), dilation=(1, 1),
                                         h_out=h, block_size=bs)
            plain = plain.reshape(9, c_in, -1).permute(1, 0, 2).reshape(c_in * 9, -1)[:, :len(real)]
            line = (f"conv_dw_fused B={b} {c_in}->{c_out} H={h} bs={bs} {str(dtype)[6:]}: gate "
                    f"{1e-4 * ref.abs().max().item():.4g}, plain err "
                    f"{(plain.double() - ref).abs().max().item():.4g}; in use "
                    f"{in_use(b * h * h, c_in * 9, len(blocks), bs, c_out)}")
            for cap in (None, 8192, 4096, 2048, 1024):
                gm.conv_dw_plan = capped(cap)
                try:
                    k = ops.conv_dw_fused_scatter(x, dy, bidx, kh=3, kw=3, stride=(1, 1),
                                                  padding=PADS, dilation=(1, 1), groups=1,
                                                  block_size=bs)[:, real]
                finally:
                    gm.conv_dw_plan = in_use
                s, chunk = capped(cap)(b * h * h, c_in * 9, len(blocks), bs, c_out)
                line += (f" | cap {cap} S={s} chunk={chunk} err "
                         f"{(k.double() - ref).abs().max().item():.4g}")
            print(line, flush=True)
    for m, d, n, blocks, bs in DENSE:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
            dy = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
            bidx = torch.tensor(blocks, dtype=torch.int32, device="cuda")
            cols = gm._expand(bidx, bs)
            ref = x.double().T @ gm.pad_channels(dy, bs).index_select(1, cols).double()
            out = gm.dw_gathered(x, dy, bidx, block_size=bs)
            plain = gm.dw_gathered_ref(x, dy, bidx, block_size=bs)
            print(f"dw_gathered M={m} D={d} N={n} bs={bs} {str(dtype)[6:]}: plan "
                  f"{gm.dw_plan(m, d, len(blocks), bs, n)}, gate "
                  f"{1e-4 * ref.abs().max().item():.4g}, kernel err "
                  f"{(out.double() - ref).abs().max().item():.4g}, plain err "
                  f"{(plain.double() - ref).abs().max().item():.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
