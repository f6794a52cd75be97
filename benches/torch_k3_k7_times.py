#!/usr/bin/env python3
"""K3's and K7's times at full width, for one tree of the PyTorch port,
on one GPU.

    python3 benches/torch_k3_k7_times.py [--root DIR] [--label NAME]
                                         [--only k3|k7]

``voxtral_tpu_torch`` is imported from DIR (default: this checkout) and
its kernels are built from DIR's sources, so two trees (a change and its
parent, unpacked with ``git archive``) run in one call in turns are timed
by one yardstick.  Each case is first held bit-equal to the tree's own
plain version (``torch.equal``), then timed

* on the device: the calls captured in a CUDA graph, the graph replayed
  (``chip_smoke.graph_ms``);
* from the host: the calls in a loop between CUDA events, twice, the
  mean (``chip_smoke.cuda_ms``: the wrapper's checks, allocations and
  ctypes call included).

The cases:

* K3 (``ops.q4_kernel.q4_matmul_packed``) at every
  ``chip_smoke.K3_SHAPES`` for M in (1, 2, 8): random packed words (any
  int32 is eight valid nibbles) and bf16 group scales of both signs;
* K7 (``ops.decode_step.decode_layer_step``) at layer 25 of random w8
  stacks at Voxtral Mini 4B's decoder shapes, 1 and 8 rows over S = 151
  and S = 413 slots (offset S - 1: a 16 s chunk, and the longest
  one-shot chunk, 30 s), and 1 row over S = 8400 with offset 8300 (the
  window full).  Per K7 case also the device ms of each launch class
  summed over a call (``torch.profiler``: the row kernels, the qkv / wo
  / w13 / w2 GEMVs in launch order, the attention, copies), and, as a
  yardstick the port never calls, torch's scaled_dot_product_attention
  over the gathered visible bf16 K / V of one call (GQA expanded to the
  query heads).

Prints the card's name and power limit, then one JSON object a case.
Exits non-zero without a CUDA device or when a case is not bit-equal
(a K3 case that is not is still timed, its line says so).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

K3_ROWS = (1, 2, 8)
K7_LAYER = 25
# (rows, cache slots S, offset)
K7_CASES = ((1, 151, 150), (8, 151, 150), (1, 413, 412), (8, 413, 412),
            (1, 8400, 8300))
# kernel-name fragment -> launch class; the rest are the GEMVs, named by
# their order in a call.
K7_CLASSES = (("row_quant", "row"),
              ("attn", "attention"), ("emcpy", "memcpy"))
K7_GEMVS = ("qkv", "wo", "w13", "w2")


def load_chip_smoke():
    """This checkout's chip_smoke.py (shapes, timing, bounds), whatever
    tree the port comes from."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def host_ms(cs, fn, iters: int) -> float:
    return (cs.cuda_ms(fn, iters) + cs.cuda_ms(fn, iters)) / 2


def run_k3(cs, k3, dev, card, label) -> bool:
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    ok = True
    for n, k in cs.K3_SHAPES:
        packed = torch.randint(-2 ** 31, 2 ** 31, (k // 8, n),
                               dtype=torch.int32, device=dev, generator=gen)
        sign = torch.randint(0, 2, (k // 32, n), device=dev,
                             generator=gen) * 2 - 1
        scales = ((torch.rand((k // 32, n), device=dev, generator=gen)
                   * 4e-3 + 1e-3) * sign).to(torch.bfloat16)
        for m in K3_ROWS:
            x = torch.randn((m, k), device=dev, generator=gen)
            call = lambda: k3.q4_matmul_packed(x, packed, scales)  # noqa
            got = call()
            torch.cuda.synchronize()
            ref = k3.q4_matmul_plain(x, packed, scales)
            equal = torch.equal(got, ref)
            if not equal:
                ok = False
                err = (got - ref).abs().max().item()
                print(f"torch_k3_k7_times: {label} K3 M={m} N={n} K={k} not "
                      f"bit-equal to plain (max abs err {err:.3e})",
                      file=sys.stderr)
            b_ms, b_by = cs.bound(cs.nbytes(x, packed, scales) + m * n * 4,
                                  2 * m * n * k, cs.BF16_FLOPS)
            print(json.dumps({
                "label": label, "kernel": "K3", "m": m, "n": n, "k": k,
                "equal": equal,
                "graph_ms": cs.graph_ms(call, reps=20, iters=10),
                "host_ms": host_ms(cs, call, 20),
                "bound_ms": b_ms, "bound_by": b_by, "card": card}),
                flush=True)
        del packed, scales
    return ok


def k7_breakdown(cs, fn, steps: int = 5) -> dict:
    """Device ms of one K7 call ``fn`` by launch class, summed over the
    call (``steps`` eager calls under ``torch.profiler``).  A kernel
    launched ahead of its predecessor (programmatic dependent launch)
    counts its wait too: time the tree in plain stream order for each
    class's own time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    evts = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not evts:
        return {"error": "the profiler saw no device time"}
    # A GEMV is qkv before the attention, then wo, w13, w2 after it (a
    # call whose first events the profiler dropped keeps its names).
    out, after, launches = {}, None, 0
    for e in evts:
        cls = next((c for frag, c in K7_CLASSES if frag in e.name), None)
        if cls == "attention":
            after = 0
        elif cls is None:
            if after is not None and after < 3:
                cls = f"gemv {K7_GEMVS[1 + after]}"
                after += 1
            else:
                cls, after = "gemv qkv", None
        launches += 1
        us = e.time_range.end - e.time_range.start
        out[cls] = out.get(cls, 0.0) + us / 1e3 / steps
    return {"classes_ms": {k: round(v, 5) for k, v in sorted(out.items())},
            "kernel_sum_ms": round(sum(out.values()), 5),
            "launches_per_call": launches / steps,
            "names": sorted({e.name[:60] for e in evts})}


def sdpa_yardstick(cs, cfg, kc, vc, off, dev) -> float:
    """Device ms of torch's scaled_dot_product_attention over the visible
    cache slots of one K7 call (bf16 q, K / V gathered and GQA expanded
    before the timing)."""
    import torch

    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lo = max(0, off - cfg.sliding_window)
    rows = kc.shape[0]
    kx = kc[:, lo:off].permute(0, 2, 1, 3).repeat_interleave(
        nh // nkv, dim=1).contiguous()
    vx = vc[:, lo:off].permute(0, 2, 1, 3).repeat_interleave(
        nh // nkv, dim=1).contiguous()
    q = torch.randn((rows, nh, 1, hd), device=dev).bfloat16()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return cs.graph_ms(lambda: sdpa(q, kx, vx), reps=20, iters=10)


def run_k7(cs, k1, cfg, dev, card, label) -> bool:
    import torch

    sys.path.insert(0, str(REPO / "benches"))
    from torch_k1_times import stacks

    w = stacks("w8", cfg, dev)
    D, hd, n_kv = cfg.dim, cfg.head_dim, cfg.n_kv_heads
    kw = dict(n_heads=cfg.n_heads, n_kv=n_kv, head_dim=hd, eps=cfg.norm_eps,
              window=cfg.sliding_window)
    layer = K7_LAYER
    wst = [w[k] for k in ("wqkv", "wo", "w13", "w2")]
    for rows, S, off in K7_CASES:
        gen = torch.Generator(device=dev).manual_seed(11 + rows + off)
        kc = (torch.randn((rows, S, n_kv, hd), device=dev, generator=gen)
              * 0.5).bfloat16()
        vc = (torch.randn((rows, S, n_kv, hd), device=dev, generator=gen)
              * 0.5).bfloat16()
        x = torch.randn((rows, D), device=dev, generator=gen)
        c, s = k1.rope_pair_vectors(off, hd, cfg.rope_theta, device=dev)
        small = (w["attn_norm"][layer], w["ffn_norm"][layer], w["ada"][layer],
                 w["sqkv"][layer], w["so"][layer], w["s13"][layer],
                 w["s2"][layer], c, s)
        args = (x, layer, off, *small, kc, vc, *wst)
        call = lambda: k1.decode_layer_step(*args, **kw)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        ref = k1.decode_layer_step_plain(*args, **kw)
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref))
            print(f"torch_k3_k7_times: {label} K7 rows={rows} S={S} "
                  f"offset={off} not bit-equal to plain (max abs err "
                  f"{err:.3e})", file=sys.stderr)
            return False
        wbytes = cs.nbytes(*(t[layer] for t in wst))
        visible = min(off, S) - max(0, off - cfg.sliding_window)
        moved = (wbytes + cs.nbytes(*small) + 2 * cs.nbytes(x)
                 + 2 * rows * visible * n_kv * hd * 2 + 2 * cs.nbytes(got[1]))
        b_ms, b_by = cs.bound(moved, 2 * rows * sum(
            t[layer].numel() for t in wst), cs.INT8_OPS)
        attn_bytes = 2 * rows * visible * n_kv * hd * 2
        # Plain stream order for the breakdown: each class's own time.
        pdl = getattr(k1, "K7_PDL", None)
        if pdl is not None:
            k1.K7_PDL = False
        breakdown = k7_breakdown(cs, call)
        if pdl is not None:
            k1.K7_PDL = pdl
        print(json.dumps({
            "label": label, "kernel": "K7", "layer": layer, "rows": rows,
            "S": S, "offset": off,
            "graph_ms": cs.graph_ms(call, reps=20, iters=10),
            "host_ms": host_ms(cs, call, 20),
            "bound_ms": b_ms, "bound_by": b_by,
            "attention_bound_ms": attn_bytes / cs.HBM_BPS * 1e3,
            "sdpa_ms": sdpa_yardstick(cs, cfg, kc, vc, off, dev),
            "breakdown": breakdown, "card": card}),
            flush=True)
        del kc, vc, got, ref
    del w
    torch.cuda.empty_cache()
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="tree to import voxtral_tpu_torch from")
    ap.add_argument("--label", default="tree", help="name in each line")
    ap.add_argument("--only", choices=("k3", "k7"), default=None,
                    help="one kernel's cases (default: both)")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    cs = load_chip_smoke()
    if not torch.cuda.is_available():
        print("torch_k3_k7_times: needs a CUDA device", file=sys.stderr)
        return 1
    from voxtral_tpu_torch import VoxtralConfig
    from voxtral_tpu_torch.ops import decode_step as k1
    from voxtral_tpu_torch.ops import q4_kernel as k3

    for mod in (k1, k3):
        if not Path(mod.__file__).resolve().is_relative_to(root):
            print(f"torch_k3_k7_times: imported {mod.__file__}, not from "
                  f"{root}", file=sys.stderr)
            return 1
    card = cs.card_line()
    print(f"{args.label}: {root} [{card}]", flush=True)
    dev = torch.device("cuda", 0)
    cfg = VoxtralConfig.voxtral().language_model
    if args.only in (None, "k3") and not run_k3(cs, k3, dev, card,
                                                args.label):
        return 1
    if args.only in (None, "k7") and not run_k7(cs, k1, cfg, dev, card,
                                                args.label):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
