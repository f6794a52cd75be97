#!/usr/bin/env python3
"""K2's times at every shape ``chip_smoke.py`` holds K2 at, for one tree
of the PyTorch port, on one GPU.

    python3 benches/torch_k2_times.py [--root DIR] [--label NAME]

``voxtral_tpu_torch`` is imported from DIR (default: this checkout), and
its kernels are built from DIR's sources, so two trees (say a change and
its parent, unpacked with ``git archive``) run in one call are timed by
one yardstick.  Per shape (``chip_smoke.k2_shapes``): the wrapper
``w8_matmul`` held bit-equal to ``w8_matmul_plain``, then timed

* on the device: 20 calls captured in a CUDA graph, the graph replayed
  10 times (``chip_smoke.graph_ms``, as ``check_k2`` times it);
* from the host: 20 calls in a loop between CUDA events, twice, the mean
  (the loop ``chip_smoke.in_turns`` runs);
* ``torch._int_mm`` + the same f32 epilogue on the device (a yardstick;
  None where it refuses the shape, M <= 16).

Prints the card's name and power limit, then one JSON object a shape.
Exits non-zero without a CUDA device or when a result is not bit-equal.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="tree to import voxtral_tpu_torch from")
    ap.add_argument("--label", default="tree", help="name in each line")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    # This checkout's chip_smoke.py (the shapes and the timing), whatever
    # tree the port comes from.
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("torch_k2_times: needs a CUDA device", file=sys.stderr)
        return 1
    from voxtral_tpu_torch import VoxtralConfig
    from voxtral_tpu_torch.ops import w8_kernel as k2

    if not Path(k2.__file__).resolve().is_relative_to(root):
        print(f"torch_k2_times: imported {k2.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"{args.label}: {root} [{card}]", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in cs.k2_shapes(VoxtralConfig.voxtral()):
        xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev,
                           generator=gen)
        codes = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                              device=dev, generator=gen)
        sx = torch.rand((m, 1), device=dev, generator=gen) * 0.1 + 1e-3
        scale = torch.rand((n,), device=dev, generator=gen) * 1e-2 + 1e-4
        call = lambda: k2.w8_matmul(xq, sx, codes, scale)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, k2.w8_matmul_plain(xq, sx, codes, scale)):
            print(f"torch_k2_times: {m}x{k}x{n} not bit-equal to plain",
                  file=sys.stderr)
            return 1
        device_ms = cs.graph_ms(call)
        host_ms = (cs.cuda_ms(call, 20) + cs.cuda_ms(call, 20)) / 2
        try:
            lib_ms = cs.graph_ms(lambda: torch._int_mm(xq, codes.T).float()
                                 * sx * scale)
        except (RuntimeError, NotImplementedError):
            lib_ms = None
        print(json.dumps({"label": args.label, "m": m, "k": k, "n": n,
                          "device_ms": device_ms, "host_ms": host_ms,
                          "int_mm_ms": lib_ms, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
