"""The slice as a whole: the port's w8 model against the JAX package.

One numpy w8 tree (dense random weights quantized by the port's
``quantize_params_w8``, itself pinned equal to the JAX one) goes into
the JAX ``VoxtralModel`` on both of its routes — the fused stack kernel
(``VOXTRAL_MEGAKERNEL=force``, Pallas interpret mode) and the XLA step
(``=0``) — and into the port through ``params_from_numpy``.

Tolerances, as a share of the stage's largest value.  Per stage, each
side gets the JAX output of the stage before, so an error is the stage's
own.  The stages compute in bf16, as the JAX w8 model does.  Where JAX
runs op by op (conv, adapter, decoder_layer0, logits_last) the port is
bit-equal (measured); tolerance one bf16 ulp, 2**-8 (1e-5 for the f32
logits).  Where JAX runs the layers as a compiled ``lax.scan`` (encoder,
final_hidden), XLA fuses the loop body and keeps some bf16 intermediates
in f32 (and turns ``/ 127`` into ``* f32(1/127)``); the port rounds after
every op as the JAX source is written.  Those one-ulp differences move
int8 activation codes and grow to 1.7e-2 (encoder) and 1.3e-2
(final_hidden) over two layers (measured); tolerance 3e-2.

Greedy tokens must be identical.  Tiny random models have near-ties
that a one-ulp difference flips (ROADMAP §3), so the configuration below
was chosen with every top-2 logit margin above 0.2; the test asserts
that margin, so a flip can be told from a fault.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voxtral_tpu.config import (
    AdapterConfig,
    AudioEncoderConfig,
    AudioInputConfig,
    LanguageModelConfig,
    VoxtralConfig,
)

SEED, SCALE, FINAL_NORM_GAIN = 9, 0.1, 6.0
MIN_MARGIN = 0.1
SCAN_TOL = 3e-2  # stages JAX runs under lax.scan (module docstring)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests, here and in every test
    module that imports this fixture: the port's CPU paths run many small
    ops and f64 products, which one thread runs faster than the default
    pool, and it leaves the cores to the other test workers (whose pools
    otherwise oversubscribe them several times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config() -> VoxtralConfig:
    """2 layers, widths 64, every dim % 8 == 0, vocab % 256 == 0."""
    return VoxtralConfig(
        audio_encoder=AudioEncoderConfig(
            dim=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
            hidden_dim=128, sliding_window=32,
        ),
        language_model=LanguageModelConfig(
            dim=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
            hidden_dim=128, vocab_size=1280, sliding_window=48,
        ),
        adapter=AdapterConfig(input_dim=256, hidden_dim=64, output_dim=64),
        audio=AudioInputConfig(),
        ada_rms_norm_t_cond_dim=8,
        downsample_factor=4,
    )


def dense_params(cfg: VoxtralConfig, seed: int, scale: float,
                 final_norm_gain: float = 1.0) -> dict:
    """Dense f32 numpy tree in the JAX package's layout (linears [in, out]).

    ``final_norm_gain`` scales the decoder's final norm, which scales the
    logits (and their top-2 margins) without touching the hidden states.
    """
    rng = np.random.default_rng(seed)
    e, lm = cfg.audio_encoder, cfg.language_model

    def r(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    def norm(*shape):
        return (1.0 + rng.normal(size=shape) * 0.1).astype(np.float32)

    L, d, f, q = e.n_layers, e.dim, e.hidden_dim, e.n_heads * e.head_dim
    encoder = {
        "conv": {"conv1": r(d, 128, 3), "conv1_b": r(d),
                 "conv2": r(d, d, 3), "conv2_b": r(d)},
        "layers": {
            "attention_norm": norm(L, d),
            "attention": {"wq": r(L, d, q), "wq_b": r(L, q), "wk": r(L, d, q),
                          "wv": r(L, d, q), "wv_b": r(L, q), "wo": r(L, q, d),
                          "wo_b": r(L, d)},
            "ffn_norm": norm(L, d),
            "ffn": {"w1": r(L, d, f), "w2": r(L, f, d), "w2_b": r(L, d),
                    "w3": r(L, d, f)},
        },
        "norm": norm(d),
    }
    L, d, f = lm.n_layers, lm.dim, lm.hidden_dim
    nq, nkv = lm.n_heads * lm.head_dim, lm.n_kv_heads * lm.head_dim
    tc = cfg.ada_rms_norm_t_cond_dim
    decoder = {
        "tok_embeddings": r(lm.vocab_size, d),
        "layers": {
            "ada": {"w0": r(L, d, tc), "w2": r(L, tc, d)},
            "attention_norm": norm(L, d),
            "attention": {"wq": r(L, d, nq), "wk": r(L, d, nkv),
                          "wv": r(L, d, nkv), "wo": r(L, nq, d)},
            "ffn_norm": norm(L, d),
            "ffn": {"w1": r(L, d, f), "w2": r(L, f, d), "w3": r(L, d, f)},
        },
        "norm": norm(d) * final_norm_gain,
    }
    adapter = {"w1": r(cfg.adapter.input_dim, lm.dim), "w2": r(lm.dim, lm.dim)}
    return {"encoder": encoder, "decoder": decoder, "adapter": adapter}


def test_mel() -> np.ndarray:
    """1.5 s dual tone, peak-normalized and padded -> log-mel [1, 128, 896]."""
    from voxtral_tpu.audio import AudioBuffer, MelSpectrogram, PadConfig, pad_audio

    sr = 16000
    t = np.arange(int(1.5 * sr)) / sr
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.2 * np.sin(2 * np.pi * 1320 * t)).astype(np.float32)
    buf = AudioBuffer(sig, sr)
    buf.peak_normalize(0.95)
    return MelSpectrogram.voxtral().compute_log_batch(
        pad_audio(buf, PadConfig.voxtral()).samples)


test_mel.__test__ = False  # a helper, not a test


@pytest.fixture(scope="module")
def setup():
    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    cfg = tiny_config()
    tree = quantize_params_w8(dense_params(cfg, SEED, SCALE, FINAL_NORM_GAIN))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg, tree, jtree, params_from_numpy(tree, "cpu"), test_mel()


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.array(_np(a))).to(torch.bfloat16)


def _check(name, got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"stage {name}: error {err:.3e} of max > {tol}"


def test_forward_stages_match_jax(setup):
    """Stage names of scripts/compare_forward_stages.py."""
    from voxtral_tpu.models import adapter as ja, decoder as jd, encoder as je
    from voxtral_tpu.models import layers as jl
    from voxtral_tpu.models.voxtral import make_prefix_ids
    from voxtral_tpu_torch.models import adapter as ta, decoder as td
    from voxtral_tpu_torch.models import encoder as te, layers as tl
    from voxtral_tpu_torch.models.time_embedding import time_embedding

    cfg, _, jp, tp, mel = setup
    ecfg, lcfg = cfg.audio_encoder, cfg.language_model
    jmel = jnp.asarray(mel).astype(jnp.bfloat16)

    j_conv = jl.conv_downsample(jmel, jp["encoder"]["conv"])
    _check("conv", tl.conv_downsample(_bf16(jmel), tp["encoder"]["conv"]),
           j_conv, 2 ** -8)

    j_enc = je.encoder_forward(jp["encoder"], jmel, ecfg)
    _check("encoder", te.encoder_forward(tp["encoder"], _bf16(jmel), ecfg),
           j_enc, SCAN_TOL)

    j_ad = ja.adapter_forward(jp["adapter"], ja.reshape_encoder_output(j_enc))
    t_ad = ta.adapter_forward(tp["adapter"],
                              ta.reshape_encoder_output(_bf16(j_enc)))
    _check("adapter", t_ad, j_ad, 2 ** -8)

    ids = make_prefix_ids()[None]
    j_in = j_ad[:, :38] + jd.embed_tokens(jp["decoder"], jnp.asarray(ids))
    t_embed = time_embedding(6.0, lcfg.dim)
    j_t, t_t = jnp.asarray(t_embed, jnp.bfloat16), _bf16(t_embed)
    S = j_ad.shape[1]

    spec = jd.decoder_spec(lcfg)
    cos, sin = jl.rope_tables(lcfg.head_dim, S, lcfg.rope_theta)
    jc = jd.create_cache(lcfg, 1, S)
    lp0 = jax.tree_util.tree_map(lambda a: a[0], jp["decoder"]["layers"])
    j_l0, _, _ = jl.decoder_block_with_cache(
        j_in, j_t, lp0, spec, cos, sin, jc.k[0], jc.v[0],
        jnp.asarray(0, jnp.int32), lcfg.norm_eps)
    tc = td.create_cache(lcfg, 1, S)
    tcos, tsin = tl.rope_tables(lcfg.head_dim, S, lcfg.rope_theta)
    t_l0, _, _ = tl.decoder_block_with_cache(
        _bf16(j_in), t_t, tl.layer_params(tp["decoder"]["layers"], 0),
        td.decoder_spec(lcfg), tcos, tsin, tc.k[0], tc.v[0], 0, lcfg.norm_eps)
    _check("decoder_layer0", t_l0, j_l0, 2 ** -8)

    j_hid, _ = jd.decoder_forward_hidden_with_cache(
        jp["decoder"], j_in, j_t, jd.create_cache(lcfg, 1, S), lcfg)
    t_hid, _ = td.decoder_forward_hidden_with_cache(
        tp["decoder"], _bf16(j_in), t_t, td.create_cache(lcfg, 1, S), lcfg)
    _check("final_hidden", t_hid, j_hid, SCAN_TOL)

    j_log = jd.lm_head(jp["decoder"], j_hid[:, -1, :], xla_only=True)
    t_log = td.lm_head(tp["decoder"], _bf16(j_hid)[:, -1, :])
    _check("logits_last", t_log, j_log, 1e-5)


@pytest.fixture(scope="module")
def jax_tokens(setup):
    """Tokens of both JAX routes (env read at model construction)."""
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel

    cfg, _, jp, _, mel = setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for route, env in (("fused", "force"), ("xla", "0")):
            mp.setenv("VOXTRAL_MEGAKERNEL", env)
            model = JaxModel(jp, cfg)
            assert (model.fused_decode is not None) == (route == "fused")
            out[route] = model.transcribe_streaming(mel)
    return out


def test_greedy_tokens_identical_to_both_jax_routes(setup, jax_tokens):
    from voxtral_tpu_torch.models.voxtral import PREFIX_LEN, VoxtralModel

    cfg, tree, _, tp, mel = setup
    model = VoxtralModel(tp, cfg, "cpu")
    model.record_margins = True
    tokens = model.transcribe_streaming(mel)
    assert tokens.dtype == np.int32
    assert len(tokens) == model.decoder_seq_len(mel.shape[-1]) - PREFIX_LEN
    assert len(set(tokens.tolist())) > 1  # not a constant stream
    margin = float(model.last_margins.min())
    assert margin > MIN_MARGIN, (
        f"top-2 margin {margin:.4f}: this configuration has a near-tie")
    assert tokens.tolist() == jax_tokens["fused"].tolist()
    assert tokens.tolist() == jax_tokens["xla"].tolist()


def test_model_from_numpy_and_batch_rows_are_independent(setup):
    """Two equal rows in one batch give the row's solo tokens."""
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, tree, _, _, mel = setup
    model = VoxtralModel.from_numpy(tree, cfg, "cpu")
    solo = model.transcribe_streaming(mel)
    batch = model.transcribe_streaming_batch(np.concatenate([mel, mel]))
    assert batch.shape == (2, len(solo))
    assert (batch == solo[None]).all()


def test_too_short_mel_returns_empty(setup):
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, _, _, tp, _ = setup
    model = VoxtralModel(tp, cfg, "cpu")
    out = model.transcribe_streaming(np.zeros((1, 128, 64), np.float32))
    assert out.shape == (0,)


def test_unported_options_raise(setup):
    """Speculative decode and sampling are ported: a bad draft policy
    raises as in JAX, and sampling with ``speculative`` rides the
    sequential loop."""
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, _, _, tp, mel = setup
    model = VoxtralModel(tp, cfg, "cpu")
    with pytest.raises(ValueError, match="draft policy"):
        model.transcribe_streaming(mel, speculative=4, draft="oracle")
    with pytest.raises(ValueError, match="draft policy"):
        model.transcribe_streaming_batch(mel, draft="oracle")
    toks = model.transcribe_streaming(mel, temperature=0.7, top_k=4,
                                      speculative=4)
    assert model.last_spec_passes == 0
    assert toks.shape == model.transcribe_streaming(mel).shape


def test_model_turns_tf32_off(setup):
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, _, _, tp, _ = setup
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    VoxtralModel(tp, cfg, "cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
