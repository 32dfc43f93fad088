#!/usr/bin/env python3
"""Measure one GPU's elementwise ceilings with imt_tpu_torch's probe kernel.

    python tools/vpu_roofline_torch.py [--rows 48] [--batch 65536]
                                       [--k1 4096] [--k2 16384]

The counterpart of tools/vpu_roofline.py (the TPU vector unit's ceiling) on
an NVIDIA GPU: k chained applications of each body per element of a
[rows, batch] array (csrc/vpu_roofline.cu: four elements a thread, the k
loop unrolled), the rate from the (k2 - k1) slope, CUDA events, best of 3
after a warm-up.  Beside the tool's six f32 bodies it runs imad16 (32-bit
multiply-adds), cios16 (two rows of the wide multiply-adds and carry chain
that the Poseidon kernels run) and wide16 (wide multiply-adds alone).  Each
rate is printed with the published peak it is held against (33.5e12
FMUL/FADD per second for f32; 132 SMs x 64 IMAD per clock x the maximum SM
clock nvidia-smi reports for the integer bodies, each wide multiply-add
counted as one IMAD) and the card's name and power limit; a share above
105% raises.  Needs a CUDA device and refuses to run without one.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=48)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--k1", type=int, default=4096)
    ap.add_argument("--k2", type=int, default=16384)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from imt_tpu_torch.ops import vpu_roofline as vr

    card = vr.nvidia_smi("name,power.limit")
    clock_mhz = float(vr.nvidia_smi("clocks.max.sm").split()[0])
    print(f"{card}; max SM clock {clock_mhz} MHz; [{args.rows}, "
          f"{args.batch}], k {args.k1}/{args.k2}")
    for r in vr.probe(clock_mhz, args.rows, args.batch, args.k1, args.k2):
        print(f"{r['name']:8s}: {r['us_per_iter']:8.3f} us/iter  "
              f"{r['t_ops_per_s']:6.2f} T census-ops/s  "
              f"({r['t_evals_per_s']:.3f} T body-evals/s)  "
              f"{r['peak_ops_per_s'] / 1e12:6.2f} T {r['peak_kind']}/s = "
              f"{100 * r['share']:5.1f}% of {r['peak_per_s'] / 1e12:.2f} T/s "
              f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
