"""W8A8 pieces of the port against the JAX package: the numpy parameter
builders, the activation quant and K2 (the W8A8 GEMM).

K2's plain version is held against ``w8_matmul_pallas`` in interpret
mode: the int32 product exactly (against numpy int64), the f32 result
to 1e-6 relative (both apply (z * sx) * scale in f32; measured equal).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voxtral_tpu.config import VoxtralConfig
from voxtral_tpu.ops.w8 import _quantize_activations as jax_quant_act
from voxtral_tpu.ops.w8 import quantize_w8_rowwise as jax_quantize_w8
from voxtral_tpu.ops.w8_pallas import w8_matmul_pallas
from voxtral_tpu.utils.quantize import quantize_params_w8 as jax_quantize_params
from voxtral_tpu.utils.quantize import random_w8_params as jax_random_w8
from voxtral_tpu_torch.device import to_torch
from voxtral_tpu_torch.ops import w8 as tw8
from voxtral_tpu_torch.ops import w8_kernel as k2
from voxtral_tpu_torch.utils.quantize import quantize_params_w8, random_w8_params

TINY_PARAMS = "tests/fixtures/params_tiny.json"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def test_quantize_w8_rowwise_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(48, 96)).astype(np.float32)
    w[3] = 0.0  # an all-zero row keeps a zero scale and zero codes
    _assert_trees_equal(tw8.quantize_w8_rowwise(w), jax_quantize_w8(w))


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensors"])
def test_quantize_params_w8_matches_jax(tensors):
    """The numpy tree, and the same tree as tensors (quantized on their
    device, as ``chip_smoke.py`` builds its dense-derived w8 tree on the
    card): the codes and scales of JAX's numpy pass, exactly."""
    from tests.test_torch_model import dense_params, tiny_config

    dense = dense_params(tiny_config(), seed=1, scale=0.1)
    got = quantize_params_w8(_tensor_tree(dense) if tensors else dense)
    _assert_trees_equal(_numpy_tree(got),
                        jax_quantize_params(dense, to_device=False))


def _tensor_tree(node):
    if isinstance(node, dict):
        return {k: _tensor_tree(v) for k, v in node.items()}
    return torch.from_numpy(np.asarray(node, np.float32))


def _numpy_tree(node):
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    return node.numpy() if isinstance(node, torch.Tensor) else node


def test_random_w8_params_matches_jax():
    cfg = VoxtralConfig.from_file(TINY_PARAMS)
    _assert_trees_equal(random_w8_params(cfg, seed=3),
                        jax_random_w8(cfg, seed=3, to_device=False))


def test_quantize_activations_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(5, 64)) * 3).astype(np.float32)
    x[1] = 0.0  # all-zero row: the 1e-8 floor
    x[2, :4] = [127 * 0.5, -127 * 0.5, 0.5, 2.5]  # half-way ties
    xq, sx = tw8.quantize_activations(torch.from_numpy(x))
    jq, js = jax_quant_act(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n", [
    (1, 256, 512),    # decode-shaped GEMV
    (7, 512, 256),    # ragged M
    (38, 256, 384),   # prefill-shaped (M = 38)
    (3, 256, 32),     # N = 32, the ADA w0 width
    (130, 512, 128),  # GEMM-shaped, M past one 64-row tile twice
])
def test_w8_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.default_rng(m * 7 + n)
    xq = rng.integers(-127, 128, size=(m, k), dtype=np.int8)
    codes = rng.integers(-127, 128, size=(n, k), dtype=np.int8)
    sx = rng.uniform(1e-3, 1e-1, size=(m, 1)).astype(np.float32)
    scale = rng.uniform(1e-4, 1e-2, size=(n,)).astype(np.float32)

    z = k2.int8_dot(torch.from_numpy(xq), torch.from_numpy(codes))
    assert z.dtype == torch.int32
    np.testing.assert_array_equal(
        z.numpy(), xq.astype(np.int64) @ codes.astype(np.int64).T)

    ref = np.asarray(w8_matmul_pallas(jnp.asarray(xq), jnp.asarray(sx),
                                      jnp.asarray(codes), jnp.asarray(scale)))
    got = k2.w8_matmul(torch.from_numpy(xq), torch.from_numpy(sx),
                       torch.from_numpy(codes), torch.from_numpy(scale))
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_w8_matmul_wrapper_checks_and_counts_no_cpu_launch():
    xq = torch.zeros((2, 32), dtype=torch.int8)
    codes = torch.zeros((8, 32), dtype=torch.int8)
    sx, scale = torch.ones((2, 1)), torch.ones(8)
    before = k2.w8_matmul.launches
    out = k2.w8_matmul(xq, sx, codes, scale)
    assert k2.w8_matmul.launches == before and out.shape == (2, 8)
    with pytest.raises(TypeError):
        k2.w8_matmul(xq.float(), sx, codes, scale)
    with pytest.raises(ValueError):
        k2.w8_matmul(xq, sx, codes[:, :16], scale)


def test_w8_linear_matches_jax_xla_path():
    """The linear-level w8_matmul (activation quant + K2) against the JAX
    w8_matmul's XLA dot, f32 activations."""
    rng = np.random.default_rng(4)
    w = jax_quantize_w8(rng.normal(size=(96, 64)).astype(np.float32))["w8"]
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    from voxtral_tpu.ops.w8 import w8_matmul as jax_w8_matmul

    ref = np.asarray(jax_w8_matmul(jnp.asarray(x),
                                   jax.tree_util.tree_map(jnp.asarray, w),
                                   prefer_pallas=False))
    got = tw8.w8_matmul(torch.from_numpy(x),
                        {k: to_torch(v, "cpu") for k, v in w.items()})
    assert got.shape == (2, 3, 96)
    # XLA computes sx as absmax * f32(1/127) under jit (a division by a
    # constant becomes a multiply); the port divides by 127 as written,
    # so sx, and every output, may sit one f32 ulp apart.
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 3072, 4096), (5, 32, 3072),
                                   (38, 3072, 4096), (200, 1280, 200),
                                   (17, 4096, 72), (64, 3072, 1000),
                                   (12, 96, 40)])
def test_w8_matmul_kernel_matches_plain_on_card(m, k, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(m + n)
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g).to(dev)
    codes = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g).to(dev)
    sx = (torch.rand((m, 1), generator=g) * 0.1 + 1e-3).to(dev)
    scale = (torch.rand((n,), generator=g) * 1e-2 + 1e-4).to(dev)
    got = k2.w8_matmul(xq, sx, codes, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, k2.w8_matmul_plain(xq, sx, codes, scale),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("m,k,n,aligned,route,splits", [
    (1, 3072, 131072, True, k2.ROUTE_GEMV, 1),      # lm_head: a weight stream
    (16, 3072, 3072, True, k2.ROUTE_GEMV, 1),       # 16 rows: still the GEMV
    (17, 256, 100, True, k2.ROUTE_WGMMA64, 1),      # too little K to split
    (64, 5120, 1280, True, k2.ROUTE_WGMMA64, 8),    # 10 tiles: K in 8 slices
    (65, 5120, 1280, True, k2.ROUTE_WGMMA128, 8),
    (608, 5120, 1280, True, k2.ROUTE_WGMMA128, 2),  # 50 tiles
    (608, 1280, 5120, True, k2.ROUTE_WGMMA128, 1),  # 200 tiles: no split
    (152, 5120, 3072, True, k2.ROUTE_WGMMA128, 2),
    (128, 5120, 1280, True, k2.ROUTE_WGMMA128, 8),
    (17, 96, 136, True, k2.ROUTE_WGMMA64, 1),       # K below one 128-byte box
    (65, 1056, 200, True, k2.ROUTE_WGMMA128, 2),    # K % 128 != 0, split
    (130, 1000, 200, True, k2.ROUTE_GEMV, 1),       # K % 32 != 0
    (608, 5120, 1280, False, k2.ROUTE_GEMV, 1),     # rows not 16-byte aligned
])
def test_k2_plan_routes_by_shape(m, k, n, aligned, route, splits):
    """K2 picks its route and K split from the shape before the launch:
    the GEMVs up to 16 rows and where the tiles cannot take the shape,
    the tensor-core GEMM above; slices only while tiles x slices fit the
    SMs, each slice at least 4 K blocks and none empty."""
    got = k2.k2_plan(m, n, k, aligned)
    assert got == (route, splits)
    if route != k2.ROUTE_GEMV:
        kb = -(-k // 128)
        per = -(-kb // splits)
        assert (splits - 1) * per < kb                # no empty slice
        assert splits == 1 or k2._tiles(m, n, route) * splits <= k2.N_SMS


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (17, 5120, 100),    # 64-row tiles, N ragged, K in slices
    (65, 5120, 130),    # 128-row tiles, M and N ragged
    (130, 1280, 300),   # three N tiles, no split
    (608, 5120, 1280),  # the one-shot encoder's w2
    (608, 1280, 2048),  # its wq / wk / wv
    (128, 5120, 1280),  # the B = 4 pool's w2: K in 8 slices
    # K % 128 != 0: the last 128-byte K box runs past K, zero-filled by
    # TMA (a partial final stage; alone below 128).
    (17, 96, 136),      # one partial box
    (65, 1056, 200),    # the last of 2 slices ends in a partial box
    (130, 4128, 300),   # 7 slices of 5 boxes, the last partial
    (130, 1000, 200),   # K % 32 != 0: the GEMV route
])
def test_w8_wgmma_matches_plain_on_card(m, k, n):
    """K2's tensor-core GEMM (and the GEMV where it cannot take the shape)
    bit-equal to the plain version; at 16 < M <= 64 the GEMV route too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(m * 3 + n)
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g).to(dev)
    codes = torch.randint(-127, 128, (n, k), dtype=torch.int8, generator=g).to(dev)
    sx = (torch.rand((m, 1), generator=g) * 0.1 + 1e-3).to(dev)
    scale = (torch.rand((n,), generator=g) * 1e-2 + 1e-4).to(dev)
    route, _ = k2.w8_matmul_route(xq, codes)
    assert (route == k2.ROUTE_GEMV) == (k % 32 != 0)
    ref = k2.w8_matmul_plain(xq, sx, codes, scale)
    got = k2.w8_matmul(xq, sx, codes, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), (got - ref).abs().max()
    if route == k2.ROUTE_WGMMA64:
        alt = k2.w8_matmul_on(k2.ROUTE_GEMV, xq, sx, codes, scale)
        torch.cuda.synchronize()
        assert torch.equal(alt, ref)
