#!/usr/bin/env python3
"""K4's, K5's and K6's times at full width, tp = 2, for one tree of the PyTorch
port, on one GPU.

    python3 benches/torch_tp_times.py [--root DIR] [--label NAME]
                                      [--only k4|k5] [--case NAME ...]
                                      [--breakdown] [--plans]

``voxtral_tpu_torch`` is imported from DIR (default: this checkout) and
its kernels are built from DIR's sources, so two trees (a change and its
parent, unpacked with ``git archive``) run in one call in turns are timed
by one yardstick.  The weights are random local stacks of one shard at
tp = 2 (16 query and 4 kv heads, 4608 hidden rows), 26 layers made on
the card from a seed, layer 25 read: w8 codes with f32 row scales, or
g32 codes with f16 group scales; K6 reads a random vocab shard of 65536
rows (``lm_shard``).  Per case (``CASES``) one ``attn_half_step`` (K4),
``ffn_half_step`` (K5) or ``lm_half_argmax`` (K6) is held bit-equal to
its plain version (``torch.equal``), then timed

* on the device: 20 calls captured in a CUDA graph, the graph replayed
  10 times (``chip_smoke.graph_ms``): back to back (``graph_ms``), and
  each call followed by the residual add a decode step puts after a
  half, ``x + out`` (``graph_ms_add``: a PyTorch kernel between two
  halves, as in ``tp_decode_step``; the plan sweep's yardstick);
* from the host: 50 calls in a loop between CUDA events, twice, the mean
  (the wrapper's checks, allocations and ctypes call included).

The cases: K4 at 1 row over S = 151 and 194 bounded slots, 8 spec rows
over 158, four streams of one row over 151 (a B = 4 pool's step), and
the four-stream cache modes of ``chip_smoke.K4_MODE_CASES`` ((d)
head+ring, (e) int8, (f) chunked bounded and on the grown ring); K5 at
1, 4 and 8 rows; K6 at 1, 2, 5 and 8 rows; each in w8 and g32.
``--breakdown`` adds, per case,
the device ms of each launch class summed over a call
(``torch.profiler``: the row kernels, the GEMVs by launch order, the
attention), in plain stream order where the tree has the switch
(``ops.decode_tp.TP_PDL``), and the call in a CUDA graph both ways.
``--plans`` times each case at 1-8 rows once more under each plan of
``PLANS`` forced on ``ops.decode_tp.tp_gemv_plan`` (trees that have it;
by ``graph_ms_add``): the sweep behind that rule; and each g32 K6 case
on its two routes (the fold of ``csrc/lm_argmax.cuh``, K1's weight
stream; ``chip_smoke.g32_routes_ms``, trees with
``ops.decode_step.STREAM_MIN_ROWS``).  It sweeps the routes
the kernel library keeps; a plan bit the shape cannot take runs the row
route, so such a plan times the same kernels as another.

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

LAYER = 25  # chip_smoke.MESH_LAYER
TP = 2
# name -> (kernel, format, S, offsets: an int (one stream, scalar offset)
# or a list (an offset tensor per stream), spec, ring, int8, chunk, dead
# slots); K5 cases carry only their rows (in ``spec``).
CASES = {}
for _fmt in ("w8", "g32"):
    CASES.update({
        f"K4 {_fmt} 1 row S=151": ("K4", _fmt, 151, 150, 1, None, False,
                                   None, None),
        f"K4 {_fmt} 8 rows S=158": ("K4", _fmt, 158, [143], 8, None, False,
                                    None, None),
        f"K4 {_fmt} 1 row S=194": ("K4", _fmt, 194, 187, 1, None, False,
                                   None, None),
        f"K4 {_fmt} 4 streams S=151": ("K4", _fmt, 151, [150, 120, 90, 60],
                                       1, None, False, None, None),
        f"K4 {_fmt} (d) 4 streams": ("K4", _fmt, 8238,
                                     [100, 8237, 8241, 16000], 1, (38, 8200),
                                     False, None, None),
        f"K4 {_fmt} (e) 4 streams": ("K4", _fmt, 8238,
                                     [100, 8237, 8241, 16000], 1, (38, 8200),
                                     True, None, None),
        f"K4 {_fmt} (f) bounded": ("K4", _fmt, 1536, [7, 700], 1, None,
                                   False, 512, slice(1024, 1536)),
        f"K4 {_fmt} (f) ring": ("K4", _fmt, 8704, [100, 16000], 1,
                                (38, 8666), False, 512, None),
    })
    for _rows in (1, 4, 8):
        CASES[f"K5 {_fmt} {_rows} rows"] = ("K5", _fmt, 0, 0, _rows, None,
                                            False, None, None)
    for _rows in (1, 2, 5, 8):
        CASES[f"K6 {_fmt} {_rows} rows"] = ("K6", _fmt, 0, 0, _rows, None,
                                            False, None, None)
VOCAB_SHARD = 65536  # K6's rows: half of the 131072-row table at tp = 2


def lm_shard(fmt: str, cfg, dev, seed: int = 5) -> dict:
    """A random vocab shard of VOCAB_SHARD rows on the card: int8 codes
    (g32: the Q4_0 range [-8, 7]) with f32 row scales or f16 group
    scales, and a final norm."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    D = cfg.dim
    lo, hi = (-8, 8) if fmt == "g32" else (-127, 128)
    codes = torch.randint(lo, hi, (VOCAB_SHARD, D), dtype=torch.int8,
                          device=dev, generator=gen)
    if fmt == "g32":
        scale = (torch.rand((VOCAB_SHARD, D // 32), device=dev,
                            generator=gen) * 2e-3 + 1e-4).half()
    else:
        scale = torch.rand((VOCAB_SHARD,), device=dev,
                           generator=gen) * 4e-4 + 1e-5
    norm = 1 + 0.1 * torch.randn((D,), device=dev, generator=gen).abs()
    return {"lm_codes": codes, "lm_scale": scale, "final_norm": norm}


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def case_call(cs, ck, name: str, w: dict, cfg, dev, ktp, seed: int):
    """(kernel call, plain call, bytes moved, int8 operations, the input
    rows) of case ``name`` on the stacks ``w`` (``cs``: chip_smoke,
    ``ck``: the chunk bench, for its caches and slot count)."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    kern, _, S, offs, spec, ring, int8, chunk, dead = CASES[name]
    D, hd = cfg.dim, cfg.head_dim
    nh, nkv = cfg.n_heads // TP, cfg.n_kv_heads // TP
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kern == "K6":
        x = torch.randn((spec, D), device=dev, generator=gen)
        pos = (x, w["final_norm"], w["lm_scale"], w["lm_codes"])
        moved = cs.nbytes(*pos[1:]) + cs.nbytes(x) + spec * 8
        ops = 2 * spec * w["lm_codes"].numel()
        return (lambda: ktp.lm_half_argmax(*pos, eps=cfg.norm_eps),
                lambda: ktp.lm_half_argmax_plain(*pos, eps=cfg.norm_eps),
                moved, ops, x)
    if kern == "K5":
        x = torch.randn((spec, D), device=dev, generator=gen)
        pos = (x, LAYER, w["ffn_norm"], w["ada"], w["s13"], w["s2"],
               w["w13"], w["w2"])
        wl = (w["w13"][LAYER], w["w2"][LAYER])
        moved = cs.nbytes(*wl, *pos[2:6]) + 2 * cs.nbytes(x)
        ops = 2 * spec * sum(t.numel() for t in wl)
        return (lambda: (ktp.ffn_half_step(*pos, eps=cfg.norm_eps),),
                lambda: (ktp.ffn_half_step_plain(*pos, eps=cfg.norm_eps),),
                moved, ops, x)
    streams = 1 if isinstance(offs, int) else len(offs)
    kc, vc, ks, vs = ck.caches(dev, gen, (streams, nkv, S, hd), int8, dead)
    x = torch.randn((streams * spec, D), device=dev, generator=gen)
    if isinstance(offs, int):
        off = offs
        c, s = k1.rope_pair_vectors(offs, hd, cfg.rope_theta, device=dev)
    else:
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        c, s = k1.rope_pair_vectors(
            (off[:, None] + torch.arange(spec, device=dev)).reshape(-1), hd,
            cfg.rope_theta)
    pos = (x, LAYER, off, w["attn_norm"], w["sqkv"], w["so"], c, s, kc, vc,
           w["wqkv"], w["wo"], ks, vs)
    kw = dict(n_heads_l=nh, n_kv_l=nkv, head_dim=hd, eps=cfg.norm_eps,
              window=cfg.sliding_window, spec=spec, ring=ring,
              cache_chunk=chunk)
    seen = ck.seen_slots([offs] if isinstance(offs, int) else offs, S, ring,
                         cfg.sliding_window, dev)
    per_slot = hd * (1 if int8 else 2) + (4 if int8 else 0)
    wl = (w["wqkv"][LAYER], w["wo"][LAYER])
    moved = (cs.nbytes(*wl, w["sqkv"], w["so"], w["attn_norm"], c, s)
             + 2 * cs.nbytes(x) + 2 * nkv * seen * per_slot
             + 2 * streams * spec * nkv * hd * 2)
    ops = 2 * streams * spec * sum(t.numel() for t in wl)
    return (lambda: ktp.attn_half_step(*pos, **kw),
            lambda: ktp.attn_half_step_plain(*pos, **kw), moved, ops, x)


def run(cs, cfg, dev, card, label, names, want_breakdown,
        want_plans) -> bool:
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1
    from voxtral_tpu_torch.ops import decode_tp as ktp

    ck = load("torch_chunk_times", REPO / "benches" / "torch_chunk_times.py")

    for fmt in ("w8", "g32"):
        todo = [n for n in names if CASES[n][1] == fmt]
        if not todo:
            continue
        w = cs.tp_stacks(fmt, cfg, dev)
        if any(CASES[n][0] == "K6" for n in todo):
            w.update(lm_shard(fmt, cfg, dev))
        for i, name in enumerate(todo):
            kern, _, S, offs, spec = CASES[name][:5]
            half, plain, moved, ops, x = case_call(cs, ck, name, w, cfg, dev,
                                                   ktp, seed=70 + i)
            res = torch.empty_like(x)

            def call(half=half, x=x, res=res, kern=kern):
                # The half, then the residual add a decode step puts
                # after it (a PyTorch kernel between two halves; none
                # after K6).
                out = half()
                if kern != "K6":
                    torch.add(x, out[0], out=res)
                return out

            got = call()
            torch.cuda.synchronize()
            ref = plain()
            if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                err = max((g.float() - r.float()).abs().max().item()
                          for g, r in zip(got, ref))
                print(f"torch_tp_times: {label} {name} not bit-equal to "
                      f"plain (max abs err {err:.3e})", file=sys.stderr)
                return False
            b_ms, b_by = cs.bound(moved, ops, cs.INT8_OPS)
            line = {"label": label, "case": name, "S": S, "offsets": offs,
                    "rows": got[0].shape[0], "graph_ms": cs.graph_ms(half),
                    "graph_ms_add": cs.graph_ms(call),
                    "host_ms": (cs.cuda_ms(half, 50)
                                + cs.cuda_ms(half, 50)) / 2,
                    "bound_ms": b_ms, "bound_by": b_by, "card": card}
            if want_breakdown:
                pdl = getattr(ktp, "TP_PDL", None)
                if pdl is not None:
                    ktp.TP_PDL = False
                    line["graph_ms_plain_order"] = cs.graph_ms(half)
                line["breakdown"] = cs.tp_breakdown(half, kern)
                if pdl is not None:
                    ktp.TP_PDL = pdl
            if want_plans and kern == "K6":
                if fmt == "g32" and hasattr(k1, "STREAM_MIN_ROWS"):
                    line["plans"] = cs.g32_routes_ms(call, ref,
                                                     ("fold", "stream"))
            elif want_plans and hasattr(ktp, "tp_gemv_plan") and \
                    got[0].shape[0] <= 8:
                line["plans"] = sweep(cs, ktp, call, plain, kern)
            print(json.dumps(line), flush=True)
            del got, ref, call, half, plain
            torch.cuda.empty_cache()
        del w
        torch.cuda.empty_cache()
    return True


def plans(ktp) -> dict:
    """The sweep's plans, {"first | second": plan function}: the first
    linear's bits (qkv / w13) and the second's (wo / w2), each forced on
    every row count and format, and "chosen", the tree's rule."""
    a, g = ktp.PLAN_AHEAD, ktp.PLAN_GEMV_AHEAD
    first = {"row": a | g, "row pair": a | g | ktp.PLAN_PAIR,
             "gated row": a | g | ktp.PLAN_SWIGLU}
    second = dict(first, **{
        "row mma": a | g | ktp.PLAN_MMA, "row, gemv ahead": g,
        "row pair, gemv ahead": g | ktp.PLAN_PAIR,
        "fused": a | ktp.PLAN_FUSED,
        "fused pair": a | ktp.PLAN_FUSED | ktp.PLAN_PAIR})

    def forced(p1: int, p2: int):
        def plan(fmt, rows, linear):
            return p1 if linear in ("qkv", "w13") else p2
        return plan

    out = {f"{n1} | {n2}": forced(p1, p2) for n1, p1 in first.items()
           for n2, p2 in second.items()}
    out["chosen"] = ktp.tp_gemv_plan
    return out


def sweep(cs, ktp, call, plain, kern: str) -> dict:
    """Device ms of ``call`` under each plan of ``plans`` (K4: not the
    gated ones, w13's), each held bit-equal to ``plain`` first: {plan:
    ms, or "not bit-equal"}."""
    import torch

    chosen = ktp.tp_gemv_plan
    ref = plain()
    out = {}
    try:
        for key, forced in plans(ktp).items():
            if kern == "K4" and key.startswith("gated"):
                continue
            ktp.tp_gemv_plan = forced
            got = call()
            torch.cuda.synchronize()
            if all(torch.equal(g, r) for g, r in zip(got, ref)):
                out[key] = cs.graph_ms(call)
            else:
                out[key] = "not bit-equal"
    finally:
        ktp.tp_gemv_plan = chosen
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="tree to import voxtral_tpu_torch from")
    ap.add_argument("--label", default="tree", help="name in each line")
    ap.add_argument("--only", choices=("k4", "k5", "k6"), default=None,
                    help="one kernel's cases (default: both)")
    ap.add_argument("--case", nargs="*", default=None,
                    help="case names to run (default: all)")
    ap.add_argument("--breakdown", action="store_true",
                    help="add each case's device ms by launch class")
    ap.add_argument("--plans", action="store_true",
                    help="time every GEMV plan the tree offers")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    cs = load("chip_smoke", REPO / "chip_smoke.py")
    if not torch.cuda.is_available():
        print("torch_tp_times: needs a CUDA device", file=sys.stderr)
        return 1
    from voxtral_tpu_torch import VoxtralConfig
    from voxtral_tpu_torch.ops import decode_tp as ktp

    if not Path(ktp.__file__).resolve().is_relative_to(root):
        print(f"torch_tp_times: imported {ktp.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"{args.label}: {root} [{card}]", flush=True)
    dev = torch.device("cuda", 0)
    cfg = VoxtralConfig.voxtral().language_model
    names = [n for n in CASES
             if (args.case is None or n in args.case)
             and (args.only is None or CASES[n][0] == args.only.upper())]
    return 0 if run(cs, cfg, dev, card, args.label, names, args.breakdown,
                    args.plans) else 1


if __name__ == "__main__":
    raise SystemExit(main())
