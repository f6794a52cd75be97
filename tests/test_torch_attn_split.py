"""The cluster walk's arithmetic against the plain attention, on the CPU.

K1 and K4 run their attention (modes (a)-(e)) as one thread-block
cluster per (stream, kv head) whose blocks split the visible slots into
contiguous pieces and merge per-piece maxima, f64 denominators, P.V
partials and (int8) absmax through distributed shared memory
(``voxtral_tpu_torch/csrc/attn_step.cuh``).  ``attention_split_plain``
states that arithmetic in PyTorch; here it is held bit for bit
(``torch.equal``) to ``_attention_plain``, the plain version the kernels
are checked against on the card, at a small size with GQA G = 4: bounded
with a window, head+ring at four ring phases (offset below the head, the
ring filling, wrapped, wrapped again), int8 caches, spec = 4 with fresh
rows, and clusters of 1, 2, 3 and 8 blocks (8: more blocks than some
streams have visible slots).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from voxtral_tpu_torch.ops import decode_step as k1

N_HEADS, N_KV, HD, S = 8, 2, 16, 24
RING = (3, 21)
WINDOW = 12
# Per-stream offsets: bounded (slots below the offset written), and
# head+ring absolute positions at four phases.
BOUNDED_OFFS = [3, 15, 24]
RING_OFFS = [2, 14, 30, 50]


def _case(ring: bool, int8: bool, spec: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    offs = RING_OFFS if ring else BOUNDED_OFFS
    bc = len(offs)
    B = bc * spec

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    q = t(B, N_HEADS, HD)
    k = t(B, N_KV, HD)
    v = t(B, N_KV, HD)
    if int8:
        kc = torch.from_numpy(rng.integers(-127, 128, (bc, N_KV, S, HD),
                                           dtype=np.int8))
        vc = torch.from_numpy(rng.integers(-127, 128, (bc, N_KV, S, HD),
                                           dtype=np.int8))
        ks = torch.from_numpy(rng.uniform(0.005, 0.02, (bc, N_KV, S))
                              .astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.005, 0.02, (bc, N_KV, S))
                              .astype(np.float32))
    else:
        kc = t(bc, N_KV, S, HD).to(torch.bfloat16)
        vc = t(bc, N_KV, S, HD).to(torch.bfloat16)
        ks = vs = None
    return dict(q=q, k=k, v=v, k_cache=kc, v_cache=vc,
                offs=torch.tensor(offs, dtype=torch.int32),
                window=WINDOW, spec=spec, n_kv=N_KV, scale=HD ** -0.5,
                ring=RING if ring else None, k_scales=ks, v_scales=vs)


@pytest.mark.parametrize("cluster", [1, 2, 3, 8])
@pytest.mark.parametrize("spec", [1, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("ring", [False, True], ids=["bounded", "ring"])
def test_split_walk_equals_plain_attention(ring, int8, spec, cluster):
    kw = _case(ring, int8, spec)
    ref = k1._attention_plain(
        kw["q"], kw["k"], kw["v"], kw["k_cache"], kw["v_cache"], kw["offs"],
        kw["window"], spec, N_KV, kw["scale"], kw["ring"], kw["k_scales"],
        kw["v_scales"])
    got = k1.attention_split_plain(
        kw["q"], kw["k"], kw["v"], kw["k_cache"], kw["v_cache"], kw["offs"],
        kw["window"], spec, N_KV, kw["scale"], cluster, kw["ring"],
        kw["k_scales"], kw["v_scales"])
    assert torch.isfinite(ref).all()
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# Mode (f): the chunked walk over a cluster
# ---------------------------------------------------------------------------
#
# ``attention_chunk_split_plain`` states mode (f)'s cluster walk: each
# stream's own visible slots (not the batch's chunk range), tile-aligned
# pieces, per-chunk maxima and their prefix max, per-chunk int8 groups
# over the pieces, f64 partials added in piece order, the f32 fold in
# chunk order.  A tile of 4 slots splits these short caches into pieces
# as the kernel's 64-slot tile splits the full-width ones; the offsets
# leave chunks of the batch's range that some stream sees nothing of.


def _chunk_ref(kw, chunk):
    return k1._attention_plain(
        kw["q"], kw["k"], kw["v"], kw["k_cache"], kw["v_cache"], kw["offs"],
        kw["window"], 1, N_KV, kw["scale"], kw["ring"], kw["k_scales"],
        kw["v_scales"], chunk)


def _chunk_split(kw, chunk, cluster, tile=4, round_chunks=None):
    return k1.attention_chunk_split_plain(
        kw["q"], kw["k"], kw["v"], kw["k_cache"], kw["v_cache"], kw["offs"],
        kw["window"], N_KV, kw["scale"], chunk, cluster, kw["ring"],
        kw["k_scales"], kw["v_scales"], round_chunks, tile)


def _poison(kw, slots, value=float("nan")):
    """Slots no stream's row reaches set to ``value`` in the arrays the
    walk multiplies (the caches over bf16, the scales over int8)."""
    if kw["k_scales"] is not None:
        kw["k_scales"][:, :, slots] = value
        kw["v_scales"][:, :, slots] = value
    else:
        kw["k_cache"][:, :, slots] = value
        kw["v_cache"][:, :, slots] = value


@pytest.mark.parametrize("case", [
    # (ring, int8, chunk, cluster, tile, round_chunks, S, offsets, dead)
    *[(r, i8, ch, c, 4, None, S, None, None)
      for r in (False, True) for i8 in (False, True)
      for ch in (4, 8, S) for c in (1, 2, 3, 8)],
    # Rounds of one and two chunks (the walk of a span longer than a
    # cluster's shared memory holds).
    *[(r, i8, 4, 2, 4, rc, S, None, None)
      for r in (False, True) for i8 in (False, True) for rc in (1, 2)],
    # Dead chunks outside the batch's range hold NaN: trailing (offsets
    # 7 / 5 / 6), leading (every window starts at slot 8 or later), past
    # the ring's end.
    *[(r, i8, 4, 3, 4, None, S, offs, dead)
      for r, offs, dead in ((False, [7, 5, 6], slice(8, 24)),
                            (False, [20, 24, 22], slice(0, 8)),
                            (True, [30, 50, 9], None))
      for i8 in (False, True)],
    # The kernel's own 64-slot tile over a longer cache.
    *[(False, i8, ch, c, 64, None, 192, [60, 150, 192], None)
      for i8 in (False, True) for ch, c in ((8, 2), (64, 3))],
], ids=lambda c: (f"{'ring' if c[0] else 'bounded'}-"
                  f"{'int8' if c[1] else 'bf16'}-chunk{c[2]}-C{c[3]}-"
                  f"tile{c[4]}-rounds{c[5]}-S{c[6]}"
                  + ("-poisoned" if c[8] is not None or c[7] is not None
                     else "")))
def test_chunk_split_walk_equals_plain_attention(case):
    ring, int8, chunk, cluster, tile, rounds, s_len, offs, dead = case
    kw = _chunk_case(ring, int8, s_len, offs)
    if dead is not None:
        _poison(kw, dead)
    if ring and offs is not None:
        _poison(kw, slice(sum(RING), s_len))  # never written
    ref = _chunk_ref(kw, chunk)
    got = _chunk_split(kw, chunk, cluster, tile, rounds)
    assert torch.isfinite(ref).all()
    assert torch.equal(got, ref)


def _chunk_case(ring: bool, int8: bool, s_len: int, offs=None):
    """``_case`` over a cache of ``s_len`` slots (a head+ring cache keeps
    RING and holds unwritten slots past its end) at ``offs``."""
    global S
    saved = S
    try:
        S = s_len
        kw = _case(ring, int8, 1, seed=3)
    finally:
        S = saved
    if offs is not None:
        kw["offs"] = torch.tensor(offs, dtype=torch.int32)
        n = len(offs)
        for key in ("q", "k", "v", "k_cache", "v_cache", "k_scales",
                    "v_scales"):
            if kw[key] is not None:
                t = kw[key]
                reps = -(-n // t.shape[0])
                kw[key] = t.repeat(reps, *[1] * (t.dim() - 1))[:n].clone()
    return kw
