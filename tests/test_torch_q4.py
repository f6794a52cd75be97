"""K3 and the q4 ops: the port's ``ops/q4.py``, ``ops/q4_kernel.py`` and
``loaders/gguf.py`` against the JAX package.

Host helpers (Q4_0 quantize / repack / pack / scale transpose) and the
GGUF reader and writer are copies: byte-equal.  K3's plain version runs
what the CUDA kernel runs (on the CPU the wrapper takes it) and is held
against the JAX Pallas kernel in interpret mode.

Tolerances, as a share of the largest |y|: both sides multiply the same
bf16 operands exactly; JAX sums them in f32, the port in f32 within each
group of 32 (by packed rows of 8) and in f64 over the groups, rounded
once, so what is left is
f32 summation order over K <= 1280 terms: 1e-5 (measured below 1e-6).  The same holds for the dequant and blocked
paths, which both sides compute as f32 matmuls of the same bf16 values.
"""

import io

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from voxtral_tpu.loaders import gguf as jgguf
from voxtral_tpu.ops import q4 as jq4
from voxtral_tpu.ops import q4_pallas as jq4p
from voxtral_tpu_torch.device import to_torch
from voxtral_tpu_torch.loaders import gguf as tgguf
from voxtral_tpu_torch.ops import q4 as tq4
from voxtral_tpu_torch.ops import q4_kernel as k3

RTOL = 1e-5  # of max |y| (module docstring)


def _weights(n, k, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, k)) * 0.05).astype(
        np.float32)


def _leaves(w):
    """(numpy unpacked leaf, numpy packed leaf) of one f32 [N, K] matrix,
    built with the JAX package's helpers."""
    q4 = jq4.repack_q4_0(jq4.quantize_q4_0(w), w.shape)
    packed = {"codes_packed": jq4p.pack_codes(q4["codes"]),
              "scales_t": jq4p.transpose_scales(q4["scales"])}
    return q4, packed


def _jax(leaf):
    return {k: jnp.asarray(v) for k, v in leaf.items()}


def _cpu(leaf):
    return {k: to_torch(v, "cpu") for k, v in leaf.items()}


def _close(got, ref, tol=RTOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


# -- host helpers ---------------------------------------------------------------


def test_host_helpers_are_byte_equal_to_jax():
    w = _weights(96, 320, seed=1)
    w[3, :32] = 0.0  # an all-zero block (scale 0)
    raw = tq4.quantize_q4_0(w)
    assert raw == jq4.quantize_q4_0(w)
    got, ref = tq4.repack_q4_0(raw, w.shape), jq4.repack_q4_0(raw, w.shape)
    for key in ("codes", "scales"):
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_array_equal(tq4.dequantize_q4_0(raw, w.size),
                                  jq4.dequantize_q4_0(raw, w.size))
    tleaf = tq4.quantize_to_q4_params(w)["q4"]
    np.testing.assert_array_equal(tleaf["codes"], ref["codes"])

    codes = got["codes"][:, :256]
    packed = k3.pack_codes(codes)
    assert packed.dtype == np.int32
    np.testing.assert_array_equal(packed, jq4p.pack_codes(codes))
    np.testing.assert_array_equal(k3.unpack_codes(packed), codes)
    np.testing.assert_array_equal(k3.unpack_codes(packed),
                                  jq4p.unpack_codes(packed))
    ts = k3.transpose_scales(got["scales"])
    jts = jq4p.transpose_scales(got["scales"])
    assert ts.dtype == jts.dtype and ts.shape == (10, 96)
    np.testing.assert_array_equal(ts.view(np.uint16), jts.view(np.uint16))


def _gguf_tensors():
    w_q4 = _weights(8, 64, seed=3)
    w_f32 = np.arange(5, dtype=np.float32) / 3
    w_f16 = (np.arange(6, dtype=np.float32) / 7).reshape(2, 3)
    return {
        "a.weight": (w_q4.shape, tgguf.GGML_Q4_0, tq4.quantize_q4_0(w_q4)),
        "b.norm": (w_f32.shape, tgguf.GGML_F32, w_f32.tobytes()),
        "c.half": (w_f16.shape, tgguf.GGML_F16,
                   w_f16.astype(np.float16).tobytes()),
    }


@pytest.mark.parametrize("writer,reader", [
    (tgguf.write_gguf, jgguf.GgufReader),  # JAX reads the port's file
    (jgguf.write_gguf, tgguf.GgufReader),  # the port reads JAX's file
])
def test_gguf_round_trips_both_ways(writer, reader):
    tensors = _gguf_tensors()
    buf = io.BytesIO()
    writer(buf, tensors)
    data = buf.getvalue()
    other = io.BytesIO()
    (jgguf.write_gguf if writer is tgguf.write_gguf
     else tgguf.write_gguf)(other, tensors)
    assert data == other.getvalue()  # the two writers agree byte for byte
    r = reader.from_bytes(data)
    assert r.version == 3 and set(r.tensor_names()) == set(tensors)
    for name, (shape, dtype, raw) in tensors.items():
        info = r.tensor_info(name)
        assert info.dtype == dtype and info.torch_shape == shape
        assert info.shape == tuple(reversed(shape))
        assert r.tensor_data(name).tobytes() == raw
    np.testing.assert_array_equal(r.tensor_f32("b.norm"),
                                  np.arange(5, dtype=np.float32) / 3)
    assert r.tensor_f32("c.half").shape == (2, 3)
    with pytest.raises(ValueError, match="magic"):
        tgguf.GgufReader.from_bytes(b"XXXX" + data[4:])


# -- K3 plain version against the Pallas kernel ---------------------------------


@pytest.mark.parametrize("m,n,k", [(1, 128, 256), (8, 256, 512),
                                   (4, 1280, 512)])
def test_q4_matmul_plain_matches_pallas(m, n, k):
    w = _weights(n, k, seed=m)
    x = (np.random.default_rng(10 + m).normal(size=(m, k)) * 0.5).astype(
        np.float32)
    _, packed = _leaves(w)
    assert jq4p.pallas_supported(jnp.asarray(x), packed)
    ref = np.asarray(jq4p.q4_matmul_pallas(jnp.asarray(x), _jax(packed)))
    tp = _cpu(packed)
    got = k3.q4_matmul_plain(to_torch(x, "cpu"), tp["codes_packed"],
                             tp["scales_t"])
    assert got.dtype == torch.float32
    _close(got, ref)
    # The wrapper takes the plain version for CPU tensors: no launch.
    before = k3.q4_matmul_packed.launches
    out = k3.q4_matmul_packed(to_torch(x, "cpu"), tp["codes_packed"],
                              tp["scales_t"])
    assert k3.q4_matmul_packed.launches == before
    assert torch.equal(out, got)


@pytest.mark.parametrize("form", ["packed", "unpacked"])
@pytest.mark.parametrize("rows", [1, 8, 9, 38])
def test_q4_matmul_dispatch_matches_jax(form, rows):
    """<= 8 rows: K3 (packed) or the blocked contraction (unpacked);
    more: the bf16 dequant + one matmul.  x in bf16, as the model feeds
    it."""
    w = _weights(256, 512, seed=4)
    unpacked, packed = _leaves(w)
    leaf = packed if form == "packed" else unpacked
    x = (np.random.default_rng(rows).normal(size=(rows, 512)) * 0.5)
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jq4.q4_matmul(jx, _jax(leaf)))
    got = tq4.q4_matmul(torch.from_numpy(np.array(jx.astype(jnp.float32)))
                        .to(torch.bfloat16), _cpu(leaf))
    _close(got, ref)
    # Leading dims are kept: [2, rows, K] -> [2, rows, N].
    x3 = torch.zeros((2, rows, 512), dtype=torch.bfloat16)
    assert tq4.q4_matmul(x3, _cpu(leaf)).shape == (2, rows, 256)


@pytest.mark.parametrize("form", ["packed", "unpacked"])
def test_q4_dequant_rows_match_jax(form):
    w = _weights(256, 512, seed=5)
    unpacked, packed = _leaves(w)
    leaf = packed if form == "packed" else unpacked
    rows = np.array([[0, 7, 255], [3, 3, 100]], np.int32)
    ref = jq4.q4_dequant_rows(_jax(leaf), jnp.asarray(rows))
    got = tq4.q4_dequant_rows(_cpu(leaf), torch.from_numpy(rows).long())
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 512)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    full = k3.q4_packed_dequant_full(_cpu(packed))
    jfull = jq4p.q4_packed_dequant_full(_jax(packed))
    np.testing.assert_array_equal(full.float().numpy(),
                                  np.asarray(jfull.astype(jnp.float32)))
    assert tq4.is_q4({"q4": leaf}) and not tq4.is_q4({"w8": {}})


def test_q4g_matmul_a8_matches_jax():
    """Same int8 activation codes, exact group dots, f32 scale epilogue:
    only f32 summation order differs — and a code that JAX's compiled
    division puts one ulp over a rounding tie (tests/test_torch_w8.py),
    which moves y by one code step; 1e-4 of max covers both."""
    w = _weights(384, 512, seed=6)
    unpacked, _ = _leaves(w)
    x = (np.random.default_rng(7).normal(size=(3, 512))).astype(np.float32)
    ref = np.asarray(jq4.q4g_matmul_a8(jnp.asarray(x),
                                       jnp.asarray(unpacked["codes"]),
                                       jnp.asarray(unpacked["scales"])))
    tl = _cpu(unpacked)
    got = tq4.q4g_matmul_a8(to_torch(x, "cpu"), tl["codes"], tl["scales"])
    _close(got, ref, 1e-4)


def test_k3_gate_and_guards():
    q4p = {"codes_packed": torch.zeros((16, 32), dtype=torch.int32),
           "scales_t": torch.zeros((4, 32), dtype=torch.bfloat16)}
    assert not k3.supported(torch.zeros((1, 128)), q4p)  # K=128, N=32
    assert not k3.supported(torch.zeros((1, 256)), {"codes": None})
    packed = torch.zeros((32, 128), dtype=torch.int32)
    scales = torch.zeros((8, 128), dtype=torch.bfloat16)
    assert k3.supported(torch.zeros((1, 256)), {"codes_packed": packed})
    with pytest.raises(ValueError, match="do not match"):
        k3.q4_matmul_packed(torch.zeros((1, 128)), packed, scales)
    with pytest.raises(TypeError, match="bf16 scales"):
        k3.q4_matmul_packed(torch.zeros((1, 256)), packed, scales.float())
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        k3.q4_matmul_packed(torch.zeros((1, 256), device=meta),
                            packed.to(meta), scales.to(meta))


def test_q4_matmul_plain_pins_f32_group_sums():
    """The stated order: each packed row's 8 exact products summed in f32
    in k order, a group's four row sums in f32 in row order, the groups
    and the offset corrections in f64, rounded once.  Held against a
    numpy loop that says just that, on inputs spread over 20 binades,
    where summing everything in f64 (the order before) gives other
    values."""
    import ml_dtypes

    rng = np.random.default_rng(21)
    m, n, k = 2, 128, 256
    x = (rng.normal(size=(m, k)) * 2.0 ** rng.uniform(-20, 0, size=(m, k))
         ).astype(np.float32)
    codes = rng.integers(-8, 8, size=(n, k)).astype(np.int8)
    scales = (rng.uniform(1e-3, 4e-3, size=(n, k // 32))
              * rng.choice([-1, 1], size=(n, k // 32))).astype(np.float16)
    packed, scales_t = k3.pack_codes(codes), k3.transpose_scales(scales)
    s32 = scales_t.astype(np.float32)  # [K/32, N], bf16 values
    xb = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    w = ((codes.T.astype(np.float32) + 8) * np.repeat(s32, 32, axis=0)
         ).astype(ml_dtypes.bfloat16).astype(np.float32)  # [K, N]
    xb8 = (x.reshape(m, -1, 32).astype(np.float64).sum(-1)
           .astype(np.float32) * np.float32(8)).astype(np.float64)
    want = np.zeros((m, n), np.float32)
    every64 = np.zeros((m, n), np.float32)
    for i in range(m):
        tot = np.zeros(n)
        for g in range(k // 32):
            rows = []
            for r in range(4):
                rs = np.zeros(n, np.float32)
                for j in range(8):
                    kk = 32 * g + 8 * r + j
                    rs = rs + np.float32(xb[i, kk]) * w[kk]
                rows.append(rs)
            gs = ((rows[0] + rows[1]) + rows[2]) + rows[3]
            tot += gs.astype(np.float64) - xb8[i, g] * s32[g].astype(
                np.float64)
        want[i] = tot.astype(np.float32)
        every64[i] = (xb[i].astype(np.float64) @ w.astype(np.float64)
                      - xb8[i] @ s32.astype(np.float64)).astype(np.float32)
    got = k3.q4_matmul_plain(torch.from_numpy(x), torch.from_numpy(packed),
                             to_torch(scales_t, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != every64).any()


def _card_q4(m, n, k, seed):
    dev = torch.device("cuda")
    w = _weights(n, k, seed=seed)
    _, packed = _leaves(w)
    tp = {key: to_torch(v, dev) for key, v in packed.items()}
    x = torch.from_numpy(np.random.default_rng(m + seed).normal(
        size=(m, k)).astype(np.float32)).to(dev)
    return x, tp["codes_packed"], tp["scales_t"]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1024, 3072), (3072, 9216), (131072, 3072),
                                 (384, 2304), (128, 256), (4096, 4096)])
@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_k3_plan_fits_and_fills(m, n, k):
    """Every plan (the library's, csrc/q4_matmul.cu::q4_plan) launches
    and gives the plain version's bits: at most 8 warps a block and 8
    blocks a cluster, whole column tiles; and where the shape has the
    columns, it keeps 3 warps an SM or more."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the plan is the CUDA library's")
    tw, kw, splits = k3.k3_plan(m, n, k)
    assert tw * kw <= k3.MAX_WARPS and 1 <= splits <= k3.MAX_SPLITS
    assert n % (k3.TILE_COLS * tw) == 0
    warps = n // k3.TILE_COLS * kw * splits
    if n * k >= 3072 * 3072:
        assert warps >= 3 * k3.SM_COUNT
    assert kw * splits <= k // 32  # every part has a group
    # Random words (any int32 is eight valid nibbles) and bf16 scales of
    # both signs, made on the card: the lm_head's table is 403 MB.
    gen = torch.Generator(device="cuda").manual_seed(m)
    packed = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // 8, n),
                           dtype=torch.int32, device="cuda", generator=gen)
    scales = (torch.randn((k // 32, n), device="cuda", generator=gen)
              * 2e-3).bfloat16()
    x = torch.randn((m, k), device="cuda", generator=gen)
    got = k3.q4_matmul_on((tw, kw, splits), x, packed, scales)
    torch.cuda.synchronize()
    assert torch.equal(got, k3.q4_matmul_plain(x, packed, scales))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(1, 128, 256), (8, 256, 512),
                                   (5, 384, 2304), (3, 1280, 1024)])
def test_q4_matmul_kernel_matches_plain_on_card(m, n, k):
    """Runs on the card only (the kernel has no CPU mode): bit-equal to
    the plain version (the same f32 group sums in k order, the groups in
    f64, rounded once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, packed, scales = _card_q4(m, n, k, seed=m)
    before = k3.q4_matmul_packed.launches
    got = k3.q4_matmul_packed(x, packed, scales)
    torch.cuda.synchronize()
    assert k3.q4_matmul_packed.launches == before + 1
    ref = k3.q4_matmul_plain(x, packed, scales)
    assert torch.equal(got, ref), (got - ref).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1024, 3072), (3072, 9216), (384, 2304)])
@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_q4_matmul_decoder_shapes_on_card(m, n, k):
    """The decoder's narrowest and deepest linears and a shape whose
    K / 32 = 72 groups the plan's 64 parts do not divide: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, packed, scales = _card_q4(m, n, k, seed=7)
    got = k3.q4_matmul_packed(x, packed, scales)
    torch.cuda.synchronize()
    ref = k3.q4_matmul_plain(x, packed, scales)
    assert torch.equal(got, ref), (got - ref).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(1, 1, 1), (2, 4, 3), (1, 8, 5),
                                  (4, 2, 1), (1, 2, 7)])
def test_q4_matmul_any_plan_on_card(plan):
    """Other plans than k3_plan's (blocks of 1 to 8 warps, clusters of
    1 to 7, group counts no part count divides) give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for m in (1, 8):
        x, packed, scales = _card_q4(m, 512, 2304, seed=9)
        got = k3.q4_matmul_on(plan, x, packed, scales)
        torch.cuda.synchronize()
        ref = k3.q4_matmul_plain(x, packed, scales)
        assert torch.equal(got, ref), (plan, m)


@pytest.mark.parametrize("pack", [True, False])
def test_q4_tree_factories_equal_jax(pack):
    """random_q4_params and quantize_params_q4 give the JAX package's
    trees leaf for leaf (the same draws, the same quantization)."""
    from tests.test_torch_gguf import gguf_cfg
    from tests.test_torch_model import SCALE, SEED, dense_params
    from voxtral_tpu.utils import quantize as jquant
    from voxtral_tpu_torch.utils import quantize as tquant

    cfg = gguf_cfg()

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, np.ascontiguousarray(tree)

    dense = dense_params(cfg, SEED, SCALE)
    pairs = [(tquant.random_q4_params(cfg, seed=3, pack=pack),
              jquant.random_q4_params(cfg, seed=3, to_device=False,
                                      pack=pack)),
             (tquant.quantize_params_q4(dense, pack=pack),
              jquant.quantize_params_q4(dense, to_device=False, pack=pack))]
    for got, ref in pairs:
        got, ref = dict(leaves(got)), dict(leaves(ref))
        assert set(got) == set(ref)
        for name in ref:
            assert got[name].dtype == ref[name].dtype, name
            np.testing.assert_array_equal(got[name].view(np.uint8),
                                          ref[name].view(np.uint8),
                                          err_msg=name)
        assert any(n.endswith("codes_packed") for n in got) == pack
