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
