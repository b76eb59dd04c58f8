#!/usr/bin/env python3
"""What the quantized kernels of the PyTorch port cost by operand layout.

    python3 perf/torch_quant_bench.py [--size N] [--seed S]

Times (CUDA events, 20 launches after a warm-up) the fp8 kernel
(`native.quant_matmul.scaled_matmul`) on an N x N x N product in each of
its four orientations ("trail": an operand stored with its contracted axis
last; "lead": first, transposed while it is staged into shared memory)
and each e4m3 / e5m2 type pair, the int8 kernel (row-quantize pre-pass
included) with its weight stored (C, N) and (N, C), and the fp8
`ops.fp8.quantize` of a bf16 activation. Prints one JSON line per
measurement, after the card's name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ORIENTATIONS = (  # (eq, a is lead, b is lead)
    ("ik,kj->ij", False, True),
    ("ik,jk->ij", False, False),
    ("ki,kj->ij", True, True),
    ("ki,jk->ij", True, False),
)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_quant_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from accelerate_tpu_torch.native import quant_matmul as qm
    from accelerate_tpu_torch.ops import fp8

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line(), flush=True)
    n = args.size
    flops = 2 * n**3
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    for eq, a_lead, b_lead in ORIENTATIONS:
        for ta in (fp8.E4M3, fp8.E5M2):
            for tb in (fp8.E4M3, fp8.E5M2):
                qa, sa = fp8.quantize(rand(n, n), ta)
                qb, sb = fp8.quantize(rand(n, n), tb)
                scale = sa * sb
                ms = chip_smoke.event_ms(torch, lambda: qm.scaled_matmul(eq, qa, qb, scale, torch.bfloat16), 20)
                print(json.dumps({
                    "kernel": "fp8_matmul", "size": n, "a": "lead" if a_lead else "trail",
                    "b": "lead" if b_lead else "trail", "types": [str(ta), str(tb)], "ms": ms,
                    "tflops": flops / ms / 1e9,
                }), flush=True)
    x = rand(n, n).bfloat16()
    for eq, b_lead in (("ik,kj->ij", True), ("ik,jk->ij", False)):
        wq = torch.randint(-127, 128, (n, n), generator=gen, device="cuda", dtype=torch.int32).to(torch.int8)
        ws = torch.rand((1, n) if b_lead else (n, 1), generator=gen, device="cuda")
        ms = chip_smoke.event_ms(torch, lambda: qm.int8_matmul(eq, x, wq, ws), 20)
        print(json.dumps({"kernel": "int8_matmul", "size": n, "b": "lead" if b_lead else "trail",
                          "ms": ms, "tops": flops / ms / 1e9}), flush=True)
    for cols in (n, n * 7 // 2):  # 4096 x 4096 and 4096 x 14336 at the default size
        t = rand(n, cols).bfloat16()
        ms = chip_smoke.event_ms(torch, lambda: fp8.quantize(t, fp8.E4M3), 20)
        print(json.dumps({"op": "fp8.quantize", "shape": list(t.shape), "dtype": "bf16", "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
