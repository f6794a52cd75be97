"""K1's weight stream (``csrc/k1_stream.cuh``): its plan and its
summation order, on the CPU; its g32 form on the card.

``ops.decode_step.stream_plan`` picks, per linear of a step, the chunk,
the ring depth and the grid the kernel launches with; the kernel's
shared memory follows the same formula (``stream_smem`` /
``StreamLayout``).  ``bf16_dots_split_plain`` states the order in which
the kernel sums mode (g)'s exact bf16 x bf16 products in f64: per K part
and chunk, the chunks in k order, the parts in part order, one rounding
to f32.  Held here to ``bf16_matmul_plain`` (the plain version K1 is
compared with) after the rounding, and to row-count independence: a
row's value must not depend on how many rows share the call.  The
kernel itself runs on the card only (the ``cuda`` tests here, of g32
from 2 to 64 rows, its fold and K6's shard fold; those of
``tests/test_torch_dense.py``, ``tests/test_torch_dp_bf16.py`` and
``tests/test_torch_decode_step.py``).
"""

import numpy as np
import pytest
import torch

from voxtral_tpu_torch import VoxtralConfig
from voxtral_tpu_torch.ops import decode_step as k1
from voxtral_tpu_torch.ops import decode_tp as ktp

SMS = 132  # an H100 SXM's SMs


def _k1_linears(lm):
    """(n, k) of a step's linears: qkv, wo, w13, w2 and the lm table."""
    nq, nkv = lm.n_heads * lm.head_dim, lm.n_kv_heads * lm.head_dim
    return [(nq + 2 * nkv, lm.dim), (lm.dim, nq), (2 * lm.hidden_dim, lm.dim),
            (lm.dim, lm.hidden_dim), (lm.vocab_size, lm.dim)]


FULL = _k1_linears(VoxtralConfig.voxtral().language_model)
ROWS = (1, 2, 4, 8, 9, 12, 16, 32, 33, 48, 64, 65, 128)


@pytest.mark.parametrize("fmt", ["w8", "bf16", "g32"])
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


@pytest.mark.parametrize("fmt,k", [
    (f, k) for f in ("w8", "bf16") for k in (256, 1024, 3072, 4096, 9216)
] + [("g32", k) for k in (1024, 2048, 3072, 4096, 9216)])
def test_stream_chunk_does_not_depend_on_rows(fmt, k):
    """The chunk (and with it the summation order) comes from the format
    and K alone: every row count that takes the stream gets the same."""
    chunks = {k1.stream_plan(fmt, m, 512, k, SMS).kc
              for m in ROWS if k1.stream_plan(fmt, m, 512, k, SMS)}
    assert chunks == {k1.stream_chunk(fmt, k)}


def test_stream_routes():
    """Which linears the stream takes: bf16 from 2 rows, g32 from 5, w8
    above 32 rows, nor a K it cannot split into whole steps per part (g32:
    K % 1024, its scales' 16-byte copies); mode (g)'s one-row path stays
    on bf16_row_dots, mode (h) up to 4 rows on the dp4a GEMV."""
    n, k = 6144, 3072
    assert k1.stream_plan("bf16", 1, n, k, SMS) is None
    assert k1.stream_plan("bf16", 2, n, k, SMS) is not None
    assert k1.stream_plan("w8", 32, n, k, SMS) is None
    assert k1.stream_plan("w8", 33, n, k, SMS) is not None
    assert all(k1.stream_plan("g32", m, n, k, SMS) is None
               for m in (1, 2, 3, 4))
    assert all(k1.stream_plan("g32", m, n, k, SMS) is not None
               for m in ROWS if m >= 5)
    assert k1.stream_plan("bf16", 8, n, 3000, SMS) is None  # 3000 % 128
    assert k1.stream_plan("w8", 64, n, 3000, SMS) is None
    assert k1.stream_plan("g32", 8, n, 256, SMS) is None
    assert k1.stream_plan("g32", 8, n, 4608, SMS) is None  # K5's w2 at tp 2
    assert k1.stream_chunk("bf16", 100) == 0


@pytest.mark.parametrize("k,kc", [(3072, 256), (4096, 256), (9216, 256),
                                  (128, 32), (256, 64)])
def test_stream_chunk_of_each_width(k, kc):
    """bf16 chunks of at most 512 bytes a row: 256 at the model's
    widths, the whole part at the tiny ones."""
    assert k1.stream_chunk("bf16", k) == kc


@pytest.mark.parametrize("k,kc", [(3072, 256), (4096, 256), (9216, 256),
                                  (1024, 256), (2048, 256), (256, 0),
                                  (4608, 0)])
def test_g32_stream_chunk_of_each_width(k, kc):
    """g32 chunks of 256 bytes a row: a K part in whole chunks (a row's
    f16 scales of a chunk: one 16-byte piece)."""
    assert k1.stream_chunk("g32", k) == kc


def test_g32_stream_smem_and_plans():
    """The g32 slot: 16 weight rows (and up to 8 staged activation rows)
    of kc + STREAM_G32_PAD bytes, then the weight rows' f16 scales (kc /
    16 bytes a row), rounded to 128 bytes; two buffers of f64 partial
    sums.  The plans take the most blocks an SM with two stages: three
    at 8 rows (rows staged), four at 12, two at 64."""
    slot = (16 + 8) * (256 + 32) + 16 * 16
    assert slot % 128 == 0
    assert k1.stream_smem("g32", 1, 256, 2) == (4 * 2 * slot + 2 * 4 * 16
                                                * 8 * 8 + 16 * 8 * 4)
    assert k1.stream_smem("g32", 2, 256, 2) == (4 * 2 * (16 * 288 + 256)
                                                + 2 * 4 * 16 * 16 * 8
                                                + 16 * 16 * 4)
    for rows, bps, grid in ((8, 3, 384), (12, 4, 384), (64, 2, 264)):
        mt = -(-rows // 8)
        p = k1.stream_plan("g32", rows, 6144, 3072, SMS)
        assert p == k1.StreamPlan(256, 2, grid,
                                  k1.stream_smem("g32", mt, 256, 2), bps)
    assert k1.stream_plan("g32", 8, 3072, 4096, SMS).kc == 256


def test_k6_takes_the_stream_fold_from_five_g32_rows():
    """K6's route (``decode_tp.lm_stream_plan``): the stream's fold over a
    g32 vocab shard from 5 rows, lm_argmax.cuh's fold up to 4 rows and in
    w8."""
    for rows in (1, 2, 4):
        assert ktp.lm_stream_plan("g32", rows, 65536, 3072, SMS) == [0, 0, 0]
    assert ktp.lm_stream_plan("w8", 8, 65536, 3072, SMS) == [0, 0, 0]
    for rows in (5, 8, 64):
        p = k1.stream_plan("g32", rows, 65536, 3072, SMS)
        assert ktp.lm_stream_plan("g32", rows, 65536, 3072, SMS) == [
            p.kc, p.stages, p.grid]


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


# ---------------------------------------------------------------------------
# The g32 form on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def stream_from_two_rows():
    """The g32 stream forced from 2 rows (its rule takes it from 5), so
    the card tests hold the kernel at 2-4 rows too."""
    rule = k1.STREAM_MIN_ROWS["g32"]
    k1.STREAM_MIN_ROWS["g32"] = 2
    k1.stream_plan.cache_clear()
    yield
    k1.STREAM_MIN_ROWS["g32"] = rule
    k1.stream_plan.cache_clear()


def _g32_operands(dev, m, n, k, seed):
    """int8 rows [m, k] with row scales, g32 codes [n, k] in [-8, 7] and
    f16 group scales spanning about six binades, and a residual."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev,
                      generator=gen)
    w = torch.randint(-8, 8, (n, k), dtype=torch.int8, device=dev,
                      generator=gen)
    sx = torch.rand(m, device=dev, generator=gen) * 1e-2 + 1e-4
    sc = (torch.rand((n, k // 32), device=dev, generator=gen) * 2e-3
          + 3e-5).half()
    resid = torch.randn((m, n), device=dev, generator=gen)
    return x, w, sx, sc, resid


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 3072])
@pytest.mark.parametrize("m", [2, 8, 9, 16, 33, 64])
def test_g32_stream_matches_plain_on_card(m, k, stream_from_two_rows):
    """The g32 stream (N = 1000: a last group of 8 rows) bit for bit
    against g32_matmul_plain, with and without the residual, and its fold
    against the plain argmax."""
    dev = _card()
    n = 1000
    assert k1.stream_plan("g32", m, n, k, k1._sm_count(0)) is not None
    x, w, sx, sc, resid = _g32_operands(dev, m, n, k, seed=m * k)
    before = k1.k1_linear.launches
    got = k1.k1_linear(x, w, sc, sx)
    got_r = k1.k1_linear(x, w, sc, sx, resid)
    tok = k1.k1_linear(x, w, sc, sx, lm_argmax=True)
    torch.cuda.synchronize()
    assert k1.k1_linear.launches == before + 3
    ref = k1.k1_linear_plain(x, w, sc, sx)
    assert torch.equal(got, ref)
    assert torch.equal(got_r, resid + ref)
    assert torch.equal(tok, k1.lm_token_plain(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 12])
def test_g32_stream_fold_takes_the_first_index_of_a_tie_on_card(
        m, stream_from_two_rows):
    """Row 0's winner copied to the row 40 away (another 16-row group):
    the fold returns the lower index of the pair, as torch.argmax does,
    and every row's token is the plain argmax."""
    dev = _card()
    n, k = 4096, 3072
    x, w, sx, sc, _ = _g32_operands(dev, m, n, k, seed=7 + m)
    win = k1.k1_linear_plain(x, w, sc, sx).argmax(-1).tolist()
    t = win[0]
    dst = t - 40 if t >= 40 else t + 40
    w[dst], sc[dst] = w[t], sc[t]
    ref = k1.k1_linear_plain(x, w, sc, sx)
    tok = k1.k1_linear(x, w, sc, sx, lm_argmax=True)
    torch.cuda.synchronize()
    assert torch.equal(tok, k1.lm_token_plain(ref))
    assert tok[0, 0].item() == min(t, dst)
    assert ref[0, t] == ref[0, dst]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 5, 8])
def test_lm_half_argmax_g32_stream_matches_plain_on_card(rows):
    """K6 over a g32 vocab shard of 4104 rows (up to 4 rows
    lm_argmax.cuh's fold; from 5 the stream's), the maximum and its first
    local index bit for bit against lm_half_argmax_plain, with a planted
    tie across two groups."""
    dev = _card()
    v, d = 4104, 3072
    gen = torch.Generator(device=dev).manual_seed(rows)
    codes = torch.randint(-8, 8, (v, d), dtype=torch.int8, device=dev,
                          generator=gen)
    scale = (torch.rand((v, d // 32), device=dev, generator=gen) * 2e-3
             + 1e-4).half()
    fnorm = 1 + 0.1 * torch.rand(d, device=dev, generator=gen)
    x = torch.randn((rows, d), device=dev, generator=gen)
    eps = 1e-5
    _, idx = ktp.lm_half_argmax_plain(x, fnorm, scale, codes, eps=eps)
    t = idx[0, 0].item()
    dst = t - 40 if t >= 40 else t + 40
    codes[dst], scale[dst] = codes[t], scale[t]
    before = (ktp.lm_half_argmax.g32_launches,
              ktp.lm_half_argmax.stream_launches)
    got = ktp.lm_half_argmax(x, fnorm, scale, codes, eps=eps)
    torch.cuda.synchronize()
    assert (ktp.lm_half_argmax.g32_launches,
            ktp.lm_half_argmax.stream_launches) == (
                before[0] + 1, before[1] + int(rows >= 5))
    ref = ktp.lm_half_argmax_plain(x, fnorm, scale, codes, eps=eps)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert got[1][0, 0].item() == min(t, dst)
