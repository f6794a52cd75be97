#!/usr/bin/env python3
"""K1's times at full width in every weight format, for one tree of the
PyTorch port, on one GPU.

    python3 benches/torch_k1_times.py [--root DIR] [--label NAME]
                                      [--breakdown] [--only CASE ...]

``voxtral_tpu_torch`` is imported from DIR (default: this checkout) and
its kernels are built from DIR's sources, so two trees (a change and its
parent, unpacked with ``git archive``) run in one call in turns are timed
by one yardstick.  The weights are random, made on the card from a seed
at Voxtral Mini 4B's decoder shapes (26 layers, 3072 wide, vocab
131072): w8 codes with f32 row scales, g32 codes with f16 group scales,
dense bf16 stacks (qkv and w13 in segments, as ``fuse_decode_weights_bf16``
leaves them).  Per case (``CASES``: modes (a), (b), (c), (g), (h) and (i)
over each table) one ``decode_stack_step`` is held bit-equal to
``decode_stack_step_plain`` (every output, ``torch.equal``), then timed

* on the device: 10 steps captured in a CUDA graph, the graph replayed
  5 times (``chip_smoke.graph_ms``);
* from the host: 10 steps in a loop between CUDA events, twice, the mean.

Beside the bf16 cases, ``torch.matmul`` of the bf16 operands at the
step's GEMV shapes (f32 sums in hardware order, bf16 out), summed over a
step: a yardstick of the bytes, not the same function (no single PyTorch
call sums the products in f64).  ``--breakdown`` adds, for the cases of
``BREAKDOWN``, the device time of each launch class summed
over a step (``chip_smoke.k1_breakdown``: ``torch.profiler``, in plain
stream order where the tree launches ahead; its ``gemv_launches_per_step``
counts the lm fold's table passes too).  ``--plans`` times each g32
case once more on each g32 route, every linear of the step on the
earlier GEMVs and folds or on the weight stream
(``chip_smoke.g32_routes_ms``, trees with ``decode_step.STREAM_MIN_ROWS``),
each held bit-equal first: the sweep behind the rule's g32 row
threshold.

Prints the card's name and power limit, then one JSON object a case.
Exits non-zero without a CUDA device or when a case is not bit-equal.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SPREAD = [150 + round(i * 85 / 7) for i in range(8)]  # 8 streams, 150..235
ROWS4 = [60, 120, 180, 235]
# name -> (weight format, offsets: an int (one stream, scalar offset) or
# a list (an offset tensor per stream), spec, lm_argmax)
CASES = {
    "(a) w8 1 row": ("w8", 235, 1, False),
    "(b) w8 8 rows": ("w8", [235], 8, False),
    "(b) w8 64 rows": ("w8", SPREAD, 8, False),
    "(c) w8 4 rows": ("w8", ROWS4, 1, False),
    "(h) g32 1 row": ("g32", 235, 1, False),
    "(h) g32 2 rows": ("g32", [235], 2, False),
    "(h) x (c) g32 4 rows": ("g32", ROWS4, 1, False),
    "(h) g32 5 rows": ("g32", [235], 5, False),
    "(h) g32 6 rows": ("g32", [235], 6, False),
    "(h) g32 8 rows": ("g32", [235], 8, False),
    "(h) g32 64 rows": ("g32", SPREAD, 8, False),
    "(g) bf16 1 row": ("bf16", 235, 1, False),
    "(g) x (c) bf16 4 rows": ("bf16", ROWS4, 1, False),
    "(g) bf16 8 rows": ("bf16", [235], 8, False),
    "(g) bf16 64 rows": ("bf16", SPREAD, 8, False),
    "(i) w8 1 row": ("w8", [235], 1, True),
    "(i) w8 8 rows": ("w8", [235], 8, True),
    "(i) w8 12 rows": ("w8", [235], 12, True),
    "(i) g32 1 row": ("g32", [235], 1, True),
    "(i) g32 8 rows": ("g32", [235], 8, True),
    "(i) g32 12 rows": ("g32", [235], 12, True),
    "(i) bf16 1 row": ("bf16", [235], 1, True),
    "(i) bf16 8 rows": ("bf16", [235], 8, True),
    "(i) bf16 12 rows": ("bf16", [235], 12, True),
}
BREAKDOWN = ("(a) w8 1 row", "(g) bf16 1 row", "(g) bf16 8 rows",
             "(h) g32 8 rows", "(i) g32 12 rows")


def stacks(fmt: str, cfg, dev, seed: int = 0) -> dict:
    """Random fused K1 weights of one format at the config's shapes, on
    the card: the four stacks, their scales, the norms, ADA vectors and
    the lm table (w8 / g32: codes + scales; bf16: the dense table)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    L, D, F, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size
    nq, nkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=dev,
                             generator=gen)

    def scales(n, k, lead=(L,)):
        if fmt == "g32":
            return (torch.rand((*lead, n, k // 32), device=dev, generator=gen)
                    * 2e-3 + 1e-4).half()
        return torch.rand((*lead, n), device=dev, generator=gen) * 4e-4 + 1e-5

    def dense(*shape):
        return (torch.randn(shape, device=dev, generator=gen)
                * 0.02).bfloat16()

    w = {"attn_norm": 1 + 0.1 * torch.randn((L, D), device=dev, generator=gen),
         "ffn_norm": 1 + 0.1 * torch.randn((L, D), device=dev, generator=gen),
         "ada": 1 + 0.1 * torch.randn((L, D), device=dev, generator=gen),
         "final_norm": 1 + 0.1 * torch.randn((D,), device=dev, generator=gen)}
    if fmt == "bf16":
        w.update(wqkv=(dense(L, nq, D), dense(L, nkv, D), dense(L, nkv, D)),
                 wo=dense(L, D, nq), w13=(dense(L, F, D), dense(L, F, D)),
                 w2=dense(L, D, F), sqkv=None, so=None, s13=None, s2=None,
                 lm_codes=dense(V, D), lm_scale=None)
        return w
    w.update(wqkv=codes(L, nq + 2 * nkv, D), sqkv=scales(nq + 2 * nkv, D),
             wo=codes(L, D, nq), so=scales(D, nq),
             w13=codes(L, 2 * F, D), s13=scales(2 * F, D),
             w2=codes(L, D, F), s2=scales(D, F),
             lm_codes=codes(V, D), lm_scale=scales(V, D, lead=()))
    return w


def step_args(w: dict, cfg, dev, offs, spec: int, seed: int):
    """(positional args, keywords) of one K1 step over ``w``: caches of
    S = 240 + spec - 1 slots, random x, RoPE per row when ``offs`` is a
    list (an offset tensor per stream)."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    L, D, hd = cfg.n_layers, cfg.dim, cfg.head_dim
    scalar = isinstance(offs, int)
    offl = [offs] if scalar else offs
    S, bc = 240 + spec - 1, len(offl)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (L, bc, cfg.n_kv_heads, S, hd)
    kc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    x = torch.randn((bc * spec, D), device=dev, generator=gen)
    if scalar:
        off = offs
        c, s = k1.rope_pair_vectors(offs, hd, cfg.rope_theta, device=dev)
    else:
        off = torch.tensor(offl, dtype=torch.int32, device=dev)
        pos = (off[:, None] + torch.arange(spec, device=dev)).reshape(-1)
        c, s = k1.rope_pair_vectors(pos, hd, cfg.rope_theta, device=dev)
    args = (x, off, w["attn_norm"], w["ffn_norm"], w["ada"], w["sqkv"],
            w["so"], w["s13"], w["s2"], c, s, kc, vc, w["wqkv"], w["wo"],
            w["w13"], w["w2"], w["final_norm"], w["lm_codes"], w["lm_scale"])
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=hd,
              eps=cfg.norm_eps, window=cfg.sliding_window, spec=spec)
    return args, kw


def matmul_yardstick(w: dict, rows: int, dev, cs) -> float:
    """Device ms of ``torch.matmul`` of bf16 operands at one step's GEMV
    shapes (each layer's four linears, then the lm table) at ``rows``."""
    import torch

    def segs(t):
        return t if isinstance(t, tuple) else (t,)

    L = w["wo"].shape[0]
    total = 0.0
    for key in ("wqkv", "wo", "w13", "w2"):
        for t in segs(w[key]):
            xb = torch.randn((rows, t.shape[2]), device=dev).bfloat16()
            wl = t[0]
            total += L * cs.graph_ms(lambda: torch.matmul(xb, wl.T))
    xb = torch.randn((rows, w["lm_codes"].shape[1]), device=dev).bfloat16()
    return total + cs.graph_ms(lambda: torch.matmul(xb, w["lm_codes"].T))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="tree to import voxtral_tpu_torch from")
    ap.add_argument("--label", default="tree", help="name in each line")
    ap.add_argument("--breakdown", action="store_true",
                    help="device time per launch class of " + ", ".join(
                        BREAKDOWN))
    ap.add_argument("--only", nargs="*", default=None,
                    help="case names to run (default: all)")
    ap.add_argument("--plans", action="store_true",
                    help="time the g32 cases on each g32 route")
    ap.add_argument("--pdl", type=int, default=None, choices=(0, 1),
                    help="decode_step.K1_PDL for a tree that has it: 1 "
                         "programmatic dependent launches, 0 plain stream "
                         "order")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    # This checkout's chip_smoke.py (the timing and the breakdown),
    # whatever tree the port comes from.
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        print("torch_k1_times: needs a CUDA device", file=sys.stderr)
        return 1
    from voxtral_tpu_torch import VoxtralConfig
    from voxtral_tpu_torch.ops import decode_step as k1

    if not Path(k1.__file__).resolve().is_relative_to(root):
        print(f"torch_k1_times: imported {k1.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    if args.pdl is not None:
        if not hasattr(k1, "K1_PDL"):
            print(f"torch_k1_times: {root} has no K1_PDL", file=sys.stderr)
            return 1
        k1.K1_PDL = bool(args.pdl)
    card = cs.card_line()
    print(f"{args.label}: {root} [{card}]", flush=True)
    dev = torch.device("cuda", 0)
    cfg = VoxtralConfig.voxtral().language_model
    names = args.only if args.only else list(CASES)
    for fmt in ("w8", "g32", "bf16"):
        todo = [n for n in names if CASES[n][0] == fmt]
        if not todo:
            continue
        w = stacks(fmt, cfg, dev)
        yard = {}
        for i, name in enumerate(todo):
            _, offs, spec_k, argmax = CASES[name]
            pos, kw = step_args(w, cfg, dev, offs, spec_k, seed=11 + i)
            kw["lm_argmax"] = argmax
            call = lambda: k1.decode_stack_step(*pos, **kw)  # noqa: E731
            got = call()
            torch.cuda.synchronize()
            ref = k1.decode_stack_step_plain(*pos, **kw)
            equal = all(torch.equal(g, r) for g, r in zip(got, ref))
            if not equal:
                err = max((g.float() - r.float()).abs().max().item()
                          for g, r in zip(got, ref))
                print(f"torch_k1_times: {args.label} {name} not bit-equal "
                      f"to plain (max abs err {err:.3e})", file=sys.stderr)
                return 1
            rows = pos[0].shape[0]
            line = {"label": args.label, "case": name, "rows": rows,
                    "graph_ms": cs.graph_ms(call, reps=10, iters=5),
                    "host_ms": (cs.cuda_ms(call, 10)
                                + cs.cuda_ms(call, 10)) / 2,
                    "card": card}
            if fmt == "bf16" and not argmax:
                if rows not in yard:
                    yard[rows] = matmul_yardstick(w, rows, dev, cs)
                line["bf16_matmul_ms"] = yard[rows]
            if args.breakdown and name in BREAKDOWN:
                # Plain stream order: each class's own device time.
                pdl = getattr(k1, "K1_PDL", None)
                if pdl is not None:
                    k1.K1_PDL = False
                line["breakdown"] = cs.k1_breakdown(call, cfg.n_layers)
                if pdl is not None:
                    k1.K1_PDL = pdl
            if args.plans and fmt == "g32" and hasattr(k1, "STREAM_MIN_ROWS"):
                line["plans"] = cs.g32_routes_ms(call, ref, reps=10, iters=5)
            print(json.dumps(line), flush=True)
            del got, ref, pos
        del w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
