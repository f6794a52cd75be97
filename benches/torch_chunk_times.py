#!/usr/bin/env python3
"""Mode (f)'s times at full width -- the chunked attention K1 and K4
share -- for one tree of the PyTorch port, on one GPU.

    python3 benches/torch_chunk_times.py [--root DIR] [--label NAME]
                                         [--only k1|k4|block ...]
                                         [--case NAME ...]

``voxtral_tpu_torch`` is imported from DIR (default: this checkout) and
its kernels are built from DIR's sources, so two trees (a change and its
parent, unpacked with ``git archive``) run in one call in turns are timed
by one yardstick.  Weights and caches are random, made on the card from
a seed at Voxtral Mini 4B's decoder shapes.  Each case is first held to
the tree's own plain version with ``torch.equal`` on every output (the
poisoned slots of a dead chunk hold NaN), then timed

* on the device: the calls captured in a CUDA graph, the graph replayed
  (``chip_smoke.graph_ms``);
* from the host: the calls in a loop between CUDA events, twice, the
  mean (``chip_smoke.cuda_ms``).

The cases (``K1_CASES``, ``K4_CASES``, ``BLOCK_CASES``):

* K1 (``decode_stack_step``, w8 stacks, 26 layers, the lm fold to
  logits) in mode (f), chunk 512: the bounded cache of 1536 slots at
  offsets 7 / 700 (its third chunk dead), the head+ring cache grown to
  17 chunks (38 + 8666 slots) at offsets 100 / 16000, and at the chunked
  pools' own lengths (offsets 112 / 150), each over bf16 and int8; and
  8 spec rows over the one-shot path's short cache (S = 158, bounded);
* K4 (``attn_half_step``, tp = 2 local heads, w8) in mode (f) over the
  same caches, and bounded without chunks at the one-shot path's three
  shapes (1 row S = 151, 8 spec rows S = 158, 1 row S = 194);
* the attention block alone (``attention_block``, one layer, all heads)
  in mode (f) on the grown ring, beside its bound (the visible K / V
  once, H100 peaks) and beside torch's scaled_dot_product_attention over
  the gathered visible bf16 K / V (GQA expanded, a boolean mask; a
  yardstick the port never calls: it computes neither the per-chunk
  rounding nor the int8 groups).

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

CHUNK = 512
GROWN = (38, 8704 - 38)    # the chunked pools' ring, 17 chunks of 512
DEAD = slice(1024, 1536)   # the bounded cache's third chunk
# name -> (S, offsets, ring, int8, dead slots, chunk, spec rows)
K1_CASES = {
    "K1 (f) bounded bf16": (1536, [7, 700], None, False, DEAD, CHUNK, 1),
    "K1 (f) bounded int8": (1536, [7, 700], None, True, DEAD, CHUNK, 1),
    "K1 (f) ring bf16": (8704, [100, 16000], GROWN, False, None, CHUNK, 1),
    "K1 (f) ring int8": (8704, [100, 16000], GROWN, True, None, CHUNK, 1),
    "K1 (f) ring pool lengths bf16": (8704, [112, 150], GROWN, False, None,
                                      CHUNK, 1),
    "K1 (f) ring pool lengths int8": (8704, [112, 150], GROWN, True, None,
                                      CHUNK, 1),
    "K1 8 rows S=158": (158, [143], None, False, None, None, 8),
}
# name -> (S, offsets, ring, int8, dead slots, chunk, spec rows)
K4_CASES = {
    "K4 (f) bounded bf16": (1536, [7, 700], None, False, DEAD, CHUNK, 1),
    "K4 (f) bounded int8": (1536, [7, 700], None, True, DEAD, CHUNK, 1),
    "K4 (f) ring bf16": (8704, [100, 16000], GROWN, False, None, CHUNK, 1),
    "K4 (f) ring int8": (8704, [100, 16000], GROWN, True, None, CHUNK, 1),
    "K4 1 row S=151": (151, 150, None, False, None, None, 1),
    "K4 8 rows S=158": (158, 143, None, False, None, None, 8),
    "K4 1 row S=194": (194, 187, None, False, None, None, 1),
}
# name -> (offsets, int8)
BLOCK_CASES = {
    "block (f) ring bf16 1 stream": ([16000], False),
    "block (f) ring bf16 2 streams": ([100, 16000], False),
    "block (f) ring int8 2 streams": ([100, 16000], True),
}


def load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def caches(dev, gen, shape, int8: bool, dead):
    """Random bf16 K / V of ``shape`` (slots on axis -2), or their int8
    codes and scales; ``dead`` slots NaN (in the scales over int8).
    -> (kc, vc, ks, vs)."""
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    kc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    vc = (torch.randn(shape, device=dev, generator=gen) * 0.5).bfloat16()
    ks = vs = None
    if int8:
        (kc, ks), (vc, vs) = k1.quantize_kv(kc), k1.quantize_kv(vc)
    if dead is not None:
        if int8:
            ks[..., dead] = float("nan")
            vs[..., dead] = float("nan")
        else:
            kc[..., dead, :] = float("nan")
            vc[..., dead, :] = float("nan")
    return kc, vc, ks, vs


def seen_slots(offs, S, ring, window, dev) -> int:
    """Cache slots the streams' rows see (spec = 1)."""
    from voxtral_tpu_torch.models.layers import ring_k_positions

    seen = 0
    for o in offs:
        if ring is None:
            seen += min(o, S) - max(0, o - window)
        else:
            p_abs, written = ring_k_positions(*ring, o, device=dev, slots=S)
            seen += int((written & (o - p_abs <= window)).sum())
    return seen


def held(label, name, got, ref) -> bool:
    import torch

    if all(torch.equal(g, r) for g, r in zip(got, ref)):
        return True
    err = max((g.float() - r.float()).abs().max().item()
              for g, r in zip(got, ref))
    print(f"torch_chunk_times: {label} {name} not bit-equal to plain "
          f"(max abs err {err:.3e})", file=sys.stderr)
    return False


def run_k1(cs, k1b, cfg, dev, card, label, names) -> bool:
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1

    w = k1b.stacks("w8", cfg, dev)
    L, D, hd, nkv = cfg.n_layers, cfg.dim, cfg.head_dim, cfg.n_kv_heads
    for i, name in enumerate(names):
        S, offs, ring, int8, dead, chunk, spec = K1_CASES[name]
        gen = torch.Generator(device=dev).manual_seed(50 + i)
        kc, vc, ks, vs = caches(dev, gen, (L, len(offs), nkv, S, hd), int8,
                                dead)
        x = torch.randn((len(offs) * spec, D), device=dev, generator=gen)
        off = torch.tensor(offs, dtype=torch.int32, device=dev)
        c, s = k1.rope_pair_vectors(
            (off[:, None] + torch.arange(spec, device=dev)).reshape(-1), hd,
            cfg.rope_theta)
        pos = (x, off, w["attn_norm"], w["ffn_norm"], w["ada"], w["sqkv"],
               w["so"], w["s13"], w["s2"], c, s, kc, vc, w["wqkv"], w["wo"],
               w["w13"], w["w2"], w["final_norm"], w["lm_codes"],
               w["lm_scale"])
        kw = dict(n_heads=cfg.n_heads, n_kv=nkv, head_dim=hd,
                  eps=cfg.norm_eps, window=cfg.sliding_window, ring=ring,
                  cache_chunk=chunk, spec=spec, k_scales=ks, v_scales=vs)
        call = lambda: k1.decode_stack_step(*pos, **kw)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        if not held(label, name, got, k1.decode_stack_step_plain(*pos, **kw)):
            return False
        line = {"label": label, "case": name, "S": S, "offsets": offs,
                "spec": spec,
                "slots_seen": seen_slots(offs, S, ring, cfg.sliding_window,
                                         dev),
                "graph_ms": cs.graph_ms(call, reps=10, iters=5),
                "host_ms": (cs.cuda_ms(call, 10) + cs.cuda_ms(call, 10)) / 2,
                "card": card}
        print(json.dumps(line), flush=True)
        del got, pos, kc, vc, ks, vs
        torch.cuda.empty_cache()
    return True


def k4_weights(cfg, dev):
    """Random local w8 stacks of one layer at tp = 2 (16 query, 4 kv
    heads): wqkv [1, nqkv_l, D], wo [1, D, nq_l] int8 with f32 row
    scales, the attention norm."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(7)
    D, hd = cfg.dim, cfg.head_dim
    nq, nkv = cfg.n_heads // 2 * hd, cfg.n_kv_heads // 2 * hd
    nqkv = nq + 2 * nkv
    return {"wqkv": torch.randint(-127, 128, (1, nqkv, D), dtype=torch.int8,
                                  device=dev, generator=gen),
            "wo": torch.randint(-127, 128, (1, D, nq), dtype=torch.int8,
                                device=dev, generator=gen),
            "sqkv": torch.rand(nqkv, device=dev, generator=gen) * 4e-4 + 1e-5,
            "so": torch.rand(D, device=dev, generator=gen) * 4e-4 + 1e-5,
            "norm": 1 + 0.1 * torch.randn(D, device=dev, generator=gen)}


def run_k4(cs, cfg, dev, card, label, names) -> bool:
    import torch

    from voxtral_tpu_torch.ops import decode_step as k1
    from voxtral_tpu_torch.ops import decode_tp as ktp

    w = k4_weights(cfg, dev)
    nh, nkv = cfg.n_heads // 2, cfg.n_kv_heads // 2
    D, hd = cfg.dim, cfg.head_dim
    for i, name in enumerate(names):
        S, offs, ring, int8, dead, chunk, spec = K4_CASES[name]
        gen = torch.Generator(device=dev).manual_seed(70 + i)
        streams = 1 if isinstance(offs, int) else len(offs)
        kc, vc, ks, vs = caches(dev, gen, (streams, nkv, S, hd), int8, dead)
        x = torch.randn((streams * spec, D), device=dev, generator=gen)
        if isinstance(offs, int) and spec == 1:
            off = offs
            c, s = k1.rope_pair_vectors(offs, hd, cfg.rope_theta, device=dev)
        else:
            off = torch.tensor([offs] if isinstance(offs, int) else offs,
                               dtype=torch.int32, device=dev)
            c, s = k1.rope_pair_vectors(
                (off[:, None] + torch.arange(spec, device=dev)).reshape(-1),
                hd, cfg.rope_theta)
        pos = (x, 0, off, w["norm"], w["sqkv"], w["so"], c, s, kc, vc,
               w["wqkv"], w["wo"], ks, vs)
        kw = dict(n_heads_l=nh, n_kv_l=nkv, head_dim=hd, eps=cfg.norm_eps,
                  window=cfg.sliding_window, spec=spec, ring=ring,
                  cache_chunk=chunk)
        call = lambda: ktp.attn_half_step(*pos, **kw)  # noqa: E731
        got = call()
        torch.cuda.synchronize()
        if not held(label, name, got, ktp.attn_half_step_plain(*pos, **kw)):
            return False
        line = {"label": label, "case": name, "S": S, "offsets": offs,
                "spec": spec, "graph_ms": cs.graph_ms(call),
                "host_ms": (cs.cuda_ms(call, 50) + cs.cuda_ms(call, 50)) / 2,
                "card": card}
        print(json.dumps(line), flush=True)
        del got, pos, kc, vc, ks, vs
        torch.cuda.empty_cache()
    return True


def run_block(cs, cfg, dev, card, label, names) -> bool:
    import torch

    for i, name in enumerate(names):
        offs, int8 = BLOCK_CASES[name]
        r = cs.chunk_block_case(cfg, dev, offs, int8, seed=90 + i)
        if r is None:
            print(f"torch_chunk_times: {label} {name} not bit-equal to "
                  "plain", file=sys.stderr)
            return False
        ms, sdpa_ms, b_ms, b_by, seen = r
        print(json.dumps({"label": label, "case": name, "offsets": offs,
                          "slots_seen": seen, "graph_ms": ms,
                          "sdpa_ms": sdpa_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "card": card}), flush=True)
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="tree to import voxtral_tpu_torch from")
    ap.add_argument("--label", default="tree", help="name in each line")
    ap.add_argument("--only", nargs="*", default=None,
                    choices=("k1", "k4", "block"),
                    help="case groups to run (default: all)")
    ap.add_argument("--case", nargs="*", default=None,
                    help="case names to run within the groups (default: "
                         "all)")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    # This checkout's chip_smoke.py (timing, the block case) and K1
    # bench (the random stacks), whatever tree the port comes from.
    cs = load("chip_smoke", REPO / "chip_smoke.py")
    k1b = load("torch_k1_times", REPO / "benches" / "torch_k1_times.py")
    if not torch.cuda.is_available():
        print("torch_chunk_times: needs a CUDA device", file=sys.stderr)
        return 1
    from voxtral_tpu_torch import VoxtralConfig
    from voxtral_tpu_torch.ops import decode_step as k1

    if not Path(k1.__file__).resolve().is_relative_to(root):
        print(f"torch_chunk_times: imported {k1.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    card = cs.card_line()
    print(f"{args.label}: {root} [{card}]", flush=True)
    dev = torch.device("cuda", 0)
    cfg = VoxtralConfig.voxtral().language_model
    groups = args.only or ["k1", "k4", "block"]

    def pick(cases):
        return [n for n in cases if args.case is None or n in args.case]

    ok = True
    if "k1" in groups and pick(K1_CASES):
        ok = ok and run_k1(cs, k1b, cfg, dev, card, args.label,
                           pick(K1_CASES))
    if "k4" in groups and pick(K4_CASES):
        ok = ok and run_k4(cs, cfg, dev, card, args.label, pick(K4_CASES))
    if "block" in groups and pick(BLOCK_CASES):
        ok = ok and run_block(cs, cfg, dev, card, args.label,
                              pick(BLOCK_CASES))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
