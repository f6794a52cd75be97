#!/usr/bin/env python3
"""K1's g32 weight stream alone, one linear of a step, under every launch
plan that fits, on one GPU.

    python3 benches/torch_g32_stream_plans.py

For each linear shape of Voxtral Mini 4B's decoder step (qkv, wo, w13,
w2, the lm table; random g32 codes and f16 group scales from a seed) and
each row count of ``ROWS``, ``vx_k1_linear`` launches the stream with
each (stages, blocks an SM) whose shared memory fits (grid: the groups
of rows or ``blocks x SMs``), held bit-equal to ``k1_linear_plain``
first, and timed on the device (CUDA events over 50 back-to-back
calls).  ``chosen`` marks ``ops.decode_step.stream_plan``'s pick.  The
sweep behind the rule's choice of many blocks an SM over deep rings.

Prints the card's name and power limit, then one JSON object a plan.
Exits non-zero without a CUDA device or when a plan is not bit-equal.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ROWS = (8, 12, 64)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_g32_stream_plans: needs a CUDA device", file=sys.stderr)
        return 1
    from voxtral_tpu_torch import VoxtralConfig
    from voxtral_tpu_torch.ops import decode_step as k1
    from voxtral_tpu_torch.ops._build import check, kernel_fn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    lm = VoxtralConfig.voxtral().language_model
    nq, nkv = lm.n_heads * lm.head_dim, lm.n_kv_heads * lm.head_dim
    shapes = {"qkv": (nq + 2 * nkv, lm.dim), "wo": (lm.dim, nq),
              "w13": (2 * lm.hidden_dim, lm.dim),
              "w2": (lm.dim, lm.hidden_dim), "lm": (lm.vocab_size, lm.dim)}
    sms = k1._sm_count(0)
    fn = kernel_fn("vx_k1_linear", [k1._I] + [k1._P] * 13 + [k1._I] * 3
                   + [k1._P, k1._P])
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, (n, k) in shapes.items():
        w = torch.randint(-8, 8, (n, k), dtype=torch.int8, device=dev,
                          generator=gen)
        sc = (torch.rand((n, k // 32), device=dev, generator=gen) * 2e-3
              + 1e-4).half()
        moved = w.numel() + sc.numel() * 2
        for m in ROWS:
            x = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                              device=dev, generator=gen)
            sx = torch.rand(m, device=dev, generator=gen) * 1e-2 + 1e-4
            out = torch.empty((m, n), device=dev)
            ref = k1.k1_linear_plain(x, w, sc, sx)
            chosen = k1.stream_plan("g32", m, n, k, sms)
            mt = -(-min(m, k1.STREAM_MAX_M) // 8)
            for stages in range(2, k1.STREAM_MAX_STAGES + 1):
                smem = k1.stream_smem("g32", mt, 256, stages)
                for bps in range(1, 5 if mt <= 4 else 3):
                    if bps * (smem + 1024) > k1.STREAM_SM_SMEM:
                        continue
                    grid = min(-(-n // 16), sms * bps)
                    plan = k1._plan_array([256, stages, grid])

                    def call():
                        check(fn(1, x.data_ptr(), sx.data_ptr(),
                                 w.data_ptr(), None, None, n, 0,
                                 sc.data_ptr(), None, out.data_ptr(), None,
                                 None, None, m, n, k, plan, stream),
                              "vx_k1_linear")

                    call()
                    torch.cuda.synchronize()
                    if not torch.equal(out, ref):
                        print(f"torch_g32_stream_plans: {name} {m} rows "
                              f"stages {stages} grid {grid}: not bit-equal",
                              file=sys.stderr)
                        return 1
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    for _ in range(50):
                        call()
                    b.record()
                    torch.cuda.synchronize()
                    ms = a.elapsed_time(b) / 50
                    print(json.dumps({
                        "linear": name, "n": n, "k": k, "rows": m,
                        "stages": stages, "blocks_per_sm": bps, "grid": grid,
                        "us": round(ms * 1e3, 2),
                        "tb_per_s": round(moved / ms / 1e9, 3),
                        "chosen": chosen is not None
                        and (chosen.stages, chosen.grid,
                             chosen.blocks_per_sm) == (stages, grid, bps),
                        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
