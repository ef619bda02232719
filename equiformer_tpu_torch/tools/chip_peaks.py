"""The rates the card sustains for the resources the DTP kernels spend.

    python -m equiformer_tpu_torch.tools.chip_peaks [--device cpu] [--grid 64]
        [--hbm-mb 256 512] [--mm 4096 8192] [--edges 40960] [--out FILE]

Counterpart of ``scripts/chip_peaks.py``.  Four measurements, each timed
with CUDA events (median of 5 runs of 5 calls after 2 warm-up calls):

* the CUDA cores' FMA rate: the S2 probe (``kernels/peaks.py``,
  ``fma_probe``), ``acc <- acc * 1.000001 + 0.5`` K times on every element
  of ones, at the script's two shapes ([grid * 512, 128] with K = 512 and
  [grid * 256, 1024] with K = 64), float32 and bfloat16: 2K operations an
  element;
* HBM streaming: ``a * 1.0001 + 1.0`` on 256 and 512 MB of bfloat16 in one
  elementwise PyTorch call (``torch.add(1.0, a, alpha=1.0001)`` with the
  1.0 a CPU scalar, so the kernel takes both constants as arguments and
  reads ``a`` in wide vectors; the script's is an XLA op), one read and one
  write an element;
* the tensor cores: a bfloat16 ``torch.matmul`` of ones at 4096 and 8192
  (the script's ``a @ a``), 2 n^3 operations;
* S1-F (``dtp_t_floor``, K6-T's byte floor at ``tools/kbench.py``'s shapes)
  as a second streaming figure, float32 and bfloat16.

Prints the card's name and power limit (``nvidia-smi``), then the report
as JSON (also to ``--out``).  Runs on the card; ``--device cpu`` runs the
plain versions on the CPU (host-clock times of the CPU, not of a card).
Published peaks of the H100 SXM, for comparison: 3.35 TB/s, 67 TFLOP/s
fp32 on the CUDA cores, 989 TFLOP/s bf16 on the tensor cores.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..kernels import dtp_t_floor, fma_probe
from ..utils.profiling import card_line, device_time_ms, resolve_device
from .kbench import flagship_tp

PUBLISHED = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12, "bf16_tensor_flops": 989e12}
# (name, rows per grid step, width, K): the script's bench_vpu and bench_vpu_wide
FMA_SHAPES = (("narrow", 512, 128, 512), ("wide", 256, 1024, 64))
DTYPES = (torch.float32, torch.bfloat16)


def _name(dt: torch.dtype) -> str:
    return str(dt).split(".")[-1]


def bench_fma(dev, grid):
    rows = []
    for dt in DTYPES:
        for name, t, width, k in FMA_SHAPES:
            x = torch.ones(grid * t, width, dtype=dt, device=dev)
            ms = device_time_ms(lambda: fma_probe(x, k), dev)
            rows.append({"dtype": _name(dt), "shape": [grid * t, width], "k": k, "variant": name,
                         "ms": ms, "tflops": 2 * k * x.numel() / ms / 1e9})
    return rows


def bench_hbm(dev, sizes_mb):
    rows = []
    for mb in sizes_mb:
        x = torch.ones(mb * 2**20 // 2, dtype=torch.bfloat16, device=dev)
        one = torch.tensor(1.0)  # a CPU scalar: a kernel argument, as alpha is
        ms = device_time_ms(lambda: torch.add(one, x, alpha=1.0001), dev)
        rows.append({"mb": mb, "ms": ms, "gb_per_s": 2 * x.numel() * 2 / ms / 1e6})
    return rows


def bench_tensor_cores(dev, sizes):
    rows = []
    for n in sizes:
        a = torch.ones(n, n, dtype=torch.bfloat16, device=dev)
        ms = device_time_ms(lambda: torch.matmul(a, a), dev)
        rows.append({"n": n, "ms": ms, "tflops": 2 * n**3 / ms / 1e9})
    return rows


def bench_floor(dev, edges):
    tp = flagship_tp()
    d_x, d_sh, d_w, d_z = (tp.irreps_in1.dim, tp.irreps_in2.dim, tp.weight_numel,
                           tp.irreps_out.dim)
    rows = []
    for dt in DTYPES:
        g = torch.Generator(device=dev).manual_seed(0)
        x, sh, w = (torch.randn(edges, d, generator=g, device=dev).to(dt) for d in (d_x, d_sh, d_w))
        ms = device_time_ms(lambda: dtp_t_floor(x, sh, w, d_z), dev)
        nbytes = edges * (d_x + d_sh + d_w + d_z) * x.element_size()
        rows.append({"dtype": _name(dt), "edges": edges, "bytes": nbytes, "ms": ms,
                     "gb_per_s": nbytes / ms / 1e6})
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu for the plain versions (default: the card)")
    ap.add_argument("--grid", type=int, default=64, help="grid steps of the FMA shapes")
    ap.add_argument("--hbm-mb", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--mm", type=int, nargs="+", default=[4096, 8192])
    ap.add_argument("--edges", type=int, default=40960, help="edges of the S1-F figure")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu (plain versions, host clock)"
    print(card, flush=True)
    report = {"card": card, "device": str(dev), "torch": torch.__version__,
              "published": PUBLISHED,
              "fma": bench_fma(dev, args.grid), "hbm": bench_hbm(dev, args.hbm_mb),
              "tensor_cores": bench_tensor_cores(dev, args.mm),
              "dtp_t_floor": bench_floor(dev, args.edges)}
    text = json.dumps(report, indent=1)
    print(text, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return report


if __name__ == "__main__":
    main()
