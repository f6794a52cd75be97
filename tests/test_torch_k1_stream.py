"""K1's weight stream (``csrc/k1_stream.cuh``): its plan and its
summation order, on the CPU.

``ops.decode_step.stream_plan`` picks, per linear of a step, the chunk,
the ring depth and the grid the kernel launches with; the kernel's
shared memory follows the same formula (``stream_smem`` /
``StreamLayout``).  ``bf16_dots_split_plain`` states the order in which
the kernel sums mode (g)'s exact bf16 x bf16 products in f64: per K part
and chunk, the chunks in k order, the parts in part order, one rounding
to f32.  Held here to ``bf16_matmul_plain`` (the plain version K1 is
compared with) after the rounding, and to row-count independence: a
row's value must not depend on how many rows share the call.  The
kernel itself runs on the card only (the ``cuda`` tests of
``tests/test_torch_dense.py``, ``tests/test_torch_dp_bf16.py`` and
``tests/test_torch_decode_step.py``).
"""

import numpy as np
import pytest
import torch

from voxtral_tpu_torch import VoxtralConfig
from voxtral_tpu_torch.ops import decode_step as k1

SMS = 132  # an H100 SXM's SMs


def _k1_linears(lm):
    """(n, k) of a step's linears: qkv, wo, w13, w2 and the lm table."""
    nq, nkv = lm.n_heads * lm.head_dim, lm.n_kv_heads * lm.head_dim
    return [(nq + 2 * nkv, lm.dim), (lm.dim, nq), (2 * lm.hidden_dim, lm.dim),
            (lm.dim, lm.hidden_dim), (lm.vocab_size, lm.dim)]


FULL = _k1_linears(VoxtralConfig.voxtral().language_model)
ROWS = (1, 2, 4, 8, 9, 12, 16, 32, 33, 48, 64, 65, 128)


@pytest.mark.parametrize("fmt", ["w8", "bf16"])
@pytest.mark.parametrize("n,k", FULL)
def test_stream_plan_fits_the_card_at_every_k1_shape(fmt, n, k):
    """Every plan at the model's shapes: the chunk splits a K part into
    whole steps, 1-4 stages, a block's shared memory within 227 KB and
    the blocks an SM is given within its 228 KB, a grid no larger than
    the groups of rows or the card."""
    esize, rows, _, align, _, _ = k1.STREAM_FMT[fmt]
    for m in ROWS:
        p = k1.stream_plan(fmt, m, n, k, SMS)
        if p is None:
            continue
        part = k // k1.STREAM_PARTS
        assert part % p.kc == 0 and p.kc % align == 0
        assert p.kc * esize <= k1.STREAM_FMT[fmt][5]
        assert 1 <= p.stages <= k1.STREAM_MAX_STAGES
        assert p.stages >= 2 or p.blocks_per_sm == 1
        mt = -(-min(m, k1.STREAM_MAX_M) // k1.STREAM_FMT[fmt][2])
        assert p.smem == k1.stream_smem(fmt, mt, p.kc, p.stages)
        assert p.smem <= k1.STREAM_BLOCK_SMEM
        assert p.blocks_per_sm * (p.smem + 1024) <= k1.STREAM_SM_SMEM
        assert 1 <= p.grid <= min(-(-n // rows), SMS * p.blocks_per_sm)


@pytest.mark.parametrize("fmt", ["w8", "bf16"])
@pytest.mark.parametrize("k", [256, 1024, 3072, 4096, 9216])
def test_stream_chunk_does_not_depend_on_rows(fmt, k):
    """The chunk (and with it the summation order) comes from the format
    and K alone: every row count that takes the stream gets the same."""
    chunks = {k1.stream_plan(fmt, m, 512, k, SMS).kc
              for m in ROWS if k1.stream_plan(fmt, m, 512, k, SMS)}
    assert chunks == {k1.stream_chunk(fmt, k)}


def test_stream_routes():
    """Which linears the stream takes: bf16 from 2 rows, w8 above 32
    rows, g32 never (the dp4a and mma GEMVs), nor a K it cannot split
    into whole steps per part; mode (g)'s one-row path stays on
    bf16_row_dots."""
    n, k = 6144, 3072
    assert k1.stream_plan("bf16", 1, n, k, SMS) is None
    assert k1.stream_plan("bf16", 2, n, k, SMS) is not None
    assert k1.stream_plan("w8", 32, n, k, SMS) is None
    assert k1.stream_plan("w8", 33, n, k, SMS) is not None
    assert all(k1.stream_plan("g32", m, n, k, SMS) is None for m in ROWS)
    assert k1.stream_plan("bf16", 8, n, 3000, SMS) is None  # 3000 % 128
    assert k1.stream_plan("w8", 64, n, 3000, SMS) is None
    assert k1.stream_chunk("bf16", 100) == 0


@pytest.mark.parametrize("k,kc", [(3072, 256), (4096, 256), (9216, 256),
                                  (128, 32), (256, 64)])
def test_stream_chunk_of_each_width(k, kc):
    """bf16 chunks of at most 512 bytes a row: 256 at the model's
    widths, the whole part at the tiny ones."""
    assert k1.stream_chunk("bf16", k) == kc


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("m,n,k", [(8, 48, 3072), (8, 40, 4096),
                                   (8, 24, 9216), (3, 16, 128),
                                   (5, 24, 256)])
def test_bf16_dots_split_plain_matches_bf16_matmul_plain(m, n, k):
    """The stream's summation order and the plain version's give the
    same f32 values: every product is exact in f64 and their exponents
    span few enough bits that the f64 sums are exact in any order."""
    rng = np.random.default_rng(k + m)
    x, w = _bf16(rng, m, k), _bf16(rng, n, k, scale=0.02)
    got = k1.bf16_dots_split_plain(x, w)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, k1.bf16_matmul_plain(x, w))


@pytest.mark.parametrize("k", [3072, 256])
def test_bf16_dots_split_plain_is_row_count_independent(k):
    """Row i of an M-row call equals its 1-row call, bit for bit, for
    M in {1, 2, 8, 12, 64}."""
    rng = np.random.default_rng(3)
    x, w = _bf16(rng, 64, k), _bf16(rng, 32, k, scale=0.02)
    ones = torch.cat([k1.bf16_dots_split_plain(x[i:i + 1], w)
                      for i in range(64)])
    for m in (1, 2, 8, 12, 64):
        assert torch.equal(k1.bf16_dots_split_plain(x[:m], w), ones[:m])


def test_bf16_dots_split_plain_refuses_a_width_the_stream_does_not_take():
    x = torch.zeros((1, 100), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        k1.bf16_dots_split_plain(x, x)


@pytest.mark.parametrize("fmt", ["w8", "g32", "bf16"])
@pytest.mark.parametrize("argmax", [False, True])
def test_k1_linear_on_the_cpu_is_its_plain_version(fmt, argmax):
    """On CPU tensors the linear entry takes its plain version and counts
    no launch: the format's product (+ the residual) or the token."""
    rng = np.random.default_rng(11)
    m, n, k = 3, 40, 256
    resid = None if argmax else torch.from_numpy(
        rng.normal(size=(m, n)).astype(np.float32))
    if fmt == "bf16":
        x = _bf16(rng, m, k)
        w = (_bf16(rng, 16, k, scale=0.02), _bf16(rng, 24, k, scale=0.02))
        sx = scale = None
        want = torch.cat([k1.bf16_matmul_plain(x, t) for t in w], dim=1)
    else:
        x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
        sx = torch.from_numpy(rng.random(m).astype(np.float32))
        if fmt == "g32":
            scale = torch.from_numpy(
                (rng.random((n, k // 32)) * 1e-3).astype(np.float16))
            want = k1.g32_matmul_plain(x, sx.reshape(-1, 1), w, scale)
        else:
            scale = torch.from_numpy(rng.random(n).astype(np.float32))
            want = k1.w8_matmul_plain(x, sx, w, scale)
    before = k1.k1_linear.launches
    got = k1.k1_linear(x, w, scale, sx, resid, lm_argmax=argmax)
    assert k1.k1_linear.launches == before
    if argmax:
        assert torch.equal(got, k1.lm_token_plain(want))
    else:
        assert torch.equal(got, resid + want)
