"""Speculative one-shot transcribe and sampling: the port against JAX.

``transcribe_streaming(speculative=K)`` verifies K drafted tokens per
row in one K1 ``spec=K`` step per pass and keeps the exact-greedy
prefix, so its tokens must equal the sequential tokens for any draft
policy and any K, solo or batched — on both sides: the JAX package
(``VOXTRAL_MEGAKERNEL=force``, the stack kernel in interpret mode) and
the port (on the CPU: the plain versions of its kernels).  The model is
the margin-checked tiny w8 model of tests/test_torch_model.py, so a
token difference is a fault and not a near-tie flip.

The helpers (``ngram_drafts``, ``append_rows``) must equal the JAX ones
exactly.  The bigram table's training scatter is the port's own rule
(the highest flat index wins where writes collide; JAX leaves that order
undefined), so it is tested on its own.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voxtral_tpu.models import voxtral as jvx
from voxtral_tpu_torch.models import voxtral as tvx

from tests.test_torch_model import (
    FINAL_NORM_GAIN,
    MIN_MARGIN,
    SCALE,
    SEED,
    dense_params,
    test_mel,
    tiny_config,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def models():
    """(JAX fused-route model, port model, 1.5 s test mel)."""
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    cfg = tiny_config()
    tree = quantize_params_w8(dense_params(cfg, SEED, SCALE, FINAL_NORM_GAIN))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        jmodel = jvx.VoxtralModel(jax.tree_util.tree_map(jnp.asarray, tree),
                                  cfg)
    assert jmodel.fused_decode is not None
    return jmodel, tvx.VoxtralModel.from_numpy(tree, cfg, "cpu"), test_mel()


@pytest.fixture(scope="module")
def sequential(models):
    """The port's sequential tokens on the test mel, margin-checked."""
    _, model, mel = models
    model.record_margins = True
    try:
        tokens = model.transcribe_streaming(mel)
        margin = float(model.last_margins.min())
    finally:
        model.record_margins = False
    assert margin > MIN_MARGIN, f"near-tie: top-2 margin {margin:.4f}"
    assert len(set(tokens.tolist())) > 1
    return tokens


def test_ngram_drafts_match_jax():
    rng = np.random.default_rng(0)
    table = rng.integers(0, 64, size=64).astype(np.int32)
    prev = rng.integers(0, 64, size=5).astype(np.int32)
    for K in (1, 2, 5):
        ref = np.asarray(jvx.ngram_drafts(jnp.asarray(table),
                                          jnp.asarray(prev), K))
        got = tvx.ngram_drafts(torch.from_numpy(table),
                               torch.from_numpy(prev), K)
        np.testing.assert_array_equal(got.numpy(), ref)
    ref0 = np.asarray(jvx.ngram_drafts(jnp.asarray(table),
                                       jnp.asarray(prev[0]), 3))
    got0 = tvx.ngram_drafts(torch.from_numpy(table),
                            torch.from_numpy(prev)[0], 3)
    np.testing.assert_array_equal(got0.numpy(), ref0)
    init = tvx.ngram_table_init(300)
    assert init.dtype == torch.int32
    np.testing.assert_array_equal(init.numpy(),
                                  np.asarray(jvx.ngram_table_init(300)))


def test_append_rows_matches_jax():
    rng = np.random.default_rng(1)
    cache = rng.normal(size=(2, 3, 2, 9, 4)).astype(np.float32)
    new = rng.normal(size=(2, 3, 2, 4)).astype(np.float32)
    offs = np.array([0, 8, 4], np.int32)
    ref = np.asarray(jvx.append_rows(jnp.asarray(cache), jnp.asarray(new),
                                     jnp.asarray(offs)))
    got = torch.from_numpy(cache.copy())
    out = tvx.append_rows(got, torch.from_numpy(new), torch.from_numpy(offs))
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), ref)


def test_append_rows_with_stream_index():
    """K fresh rows per stream land at offs[b] + j of stream b's row."""
    cache = torch.zeros((1, 2, 1, 6, 1))
    new = torch.arange(1.0, 7.0).reshape(1, 6, 1, 1)  # rows (b, j), K = 3
    at = torch.tensor([1, 2, 3, 0, 1, 2])
    tvx.append_rows(cache, new, at, torch.tensor([0, 0, 0, 1, 1, 1]))
    assert cache[0, :, 0, :, 0].tolist() == [[0, 1, 2, 3, 0, 0],
                                             [4, 5, 6, 0, 0, 0]]


def test_ngram_train_highest_flat_index_wins():
    table = tvx.ngram_table_init(10)
    drafts = torch.tensor([[3, 5, 3], [3, 7, 9]], dtype=torch.int32)
    y = torch.tensor([[11, 12, 13], [14, 15, 16]], dtype=torch.int32)
    live = torch.tensor([True, True])
    tvx.ngram_train(table, drafts, y, live)
    # Entry 3 is written by flat indices 0, 2 and 3: index 3 wins.
    assert table[3] == 14 and table[5] == 12
    assert table[7] == 15 and table[9] == 16
    untouched = [0, 1, 2, 4, 6, 8]
    assert (table[untouched] == tvx.STREAMING_PAD).all()

    # A dead row writes nothing, even where it holds the highest index.
    table = tvx.ngram_table_init(10)
    tvx.ngram_train(table, drafts, y, torch.tensor([True, False]))
    assert table[3] == 13 and table[5] == 12
    assert table[7] == tvx.STREAMING_PAD and table[9] == tvx.STREAMING_PAD


@pytest.mark.parametrize("spec_k", [2, 4, 8])
@pytest.mark.parametrize("draft", ["pad", "ngram"])
def test_spec_tokens_match_jax_and_sequential(models, sequential, spec_k,
                                              draft):
    jmodel, model, mel = models
    got = model.transcribe_streaming(mel, speculative=spec_k, draft=draft)
    np.testing.assert_array_equal(got, sequential)
    ref = jmodel.transcribe_streaming(mel, speculative=spec_k, draft=draft)
    np.testing.assert_array_equal(got, ref)
    # The spec loop ran, in fewer passes than positions when drafts hit.
    passes = model.last_spec_passes
    assert 1 <= passes <= len(sequential) - 1
    if draft == "ngram" and spec_k >= 4:
        assert passes < len(sequential) - 1


def test_spec_batched_rows_match_jax_and_sequential(models):
    """Three rows advancing by their own accepted counts.  The scales
    keep every top-2 margin above 0.25: at x0.9 a margin of 0.12 flips
    between the port and the JAX route, whose scanned prefill differs by
    ~1.3 % of the hidden state (tests/test_torch_model.py)."""
    jmodel, model, mel = models
    mel3 = np.concatenate([mel, mel * 0.8, mel * 1.3], axis=0)
    model.record_margins = True
    try:
        ref = model.transcribe_streaming_batch(mel3)
        margin = float(model.last_margins.min())
    finally:
        model.record_margins = False
    assert margin > 0.25, f"near-tie: top-2 margin {margin:.4f}"
    assert len({tuple(r) for r in ref.tolist()}) == 2  # x1.3 repeats x1
    got = model.transcribe_streaming_batch(mel3, speculative=4)
    assert got.shape[0] == 3
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.asarray(jmodel.transcribe_streaming_batch(mel3,
                                                          speculative=4)))


@pytest.mark.parametrize("positions,n_steps", [(41, 2), (39, 0)])
def test_spec_short_windows(models, positions, n_steps):
    """K = 8 > n_steps (the advance clamps to the positions left) and
    n_steps = 0 (the spec gate refuses: the prefill token alone)."""
    jmodel, model, mel = models
    short = mel[..., :positions * 16]
    assert model.decoder_seq_len(short.shape[-1]) - 39 == n_steps
    seq = model.transcribe_streaming(short)
    assert len(seq) == n_steps + 1
    got = model.transcribe_streaming(short, speculative=8)
    np.testing.assert_array_equal(got, seq)
    assert (model.last_spec_passes >= 1) == (n_steps > 0)
    assert model.last_spec_passes <= n_steps
    np.testing.assert_array_equal(
        got, jmodel.transcribe_streaming(short, speculative=8))


def test_top_k_one_sampling_is_greedy(models, sequential):
    _, model, mel = models
    got = model.transcribe_streaming(mel, temperature=0.7, top_k=1, seed=3)
    np.testing.assert_array_equal(got, sequential)


def test_sampling_is_seeded_and_rides_the_sequential_loop(models, sequential):
    _, model, mel = models
    a = model.transcribe_streaming(mel, temperature=5.0, top_k=50, seed=11,
                                   speculative=4)
    assert model.last_spec_passes == 0  # sampling is never speculative
    b = model.transcribe_streaming(mel, temperature=5.0, top_k=50, seed=11)
    c = model.transcribe_streaming(mel, temperature=5.0, top_k=50, seed=12)
    assert a.shape == sequential.shape and a.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    assert a.tolist() != c.tolist()
    assert a.tolist() != sequential.tolist()


def test_select_token_top_k_mask():
    logits = torch.tensor([[0.0, 3.0, 2.9, -1.0]] * 200)
    gen = torch.Generator().manual_seed(0)
    toks = tvx.select_token(logits, gen, temperature=1.0, top_k=2)
    assert set(toks.tolist()) == {1, 2}
    assert tvx.select_token(logits).tolist() == [1] * 200
