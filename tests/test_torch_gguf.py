"""The GGUF path as a whole: the port's ``Q4ModelLoader``,
``TranscribePipeline.from_gguf`` and ``--gguf`` CLI against the JAX
package, on a tiny synthetic Q4_0 GGUF.

The checkpoint is ``tests/test_q4.py::q4_checkpoint``'s recipe (every
linear with K % 32 == 0 quantized to Q4_0, norms / biases / conv F32)
on a decoder whose widths are multiples of 256, so K3 takes every
decoder linear and the lm_head, and the q4g geometry qualifies.

Routes: ``q4`` keeps packed leaves and decodes op by op (JAX: the XLA
step with the Pallas K3 in interpret mode; the port: K3's plain version
on the CPU); ``q4g`` keeps the unpacked leaves and decodes through the
stack step in g32 mode (JAX: ``VOXTRAL_MEGAKERNEL=force``, interpret
mode); ``w8`` requantizes at load.  Greedy tokens must be identical;
the configuration has every top-2 logit margin above MIN_MARGIN (the
test asserts it), so a flip can be told from a fault.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from voxtral_tpu.config import (
    AdapterConfig,
    AudioEncoderConfig,
    AudioInputConfig,
    LanguageModelConfig,
    VoxtralConfig,
)
from voxtral_tpu.loaders import names as N
from voxtral_tpu.loaders.gguf import GGML_F32, GGML_Q4_0, write_gguf
from voxtral_tpu.ops.q4 import quantize_q4_0

from tests.test_torch_model import test_mel
from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_pipeline import tekken_json

MIN_MARGIN = 0.05


def gguf_cfg() -> VoxtralConfig:
    """Decoder widths % 256 (K3's gate) and % 128 (q4g's geometry)."""
    return VoxtralConfig(
        audio_encoder=AudioEncoderConfig(
            dim=64, n_layers=2, n_heads=2, n_kv_heads=2, head_dim=32,
            hidden_dim=128, sliding_window=64,
        ),
        language_model=LanguageModelConfig(
            dim=256, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
            hidden_dim=512, vocab_size=1280, sliding_window=64,
        ),
        adapter=AdapterConfig(input_dim=256, hidden_dim=256, output_dim=256),
        audio=AudioInputConfig(),
        ada_rms_norm_t_cond_dim=32,
        downsample_factor=4,
    )


def _tensors(cfg: VoxtralConfig, rng) -> dict:
    """Every tensor under its checkpoint name, [out, in] linears, scaled
    so the tiny random model's activations stay moderate."""
    from tests.test_safetensors_loader import synth_checkpoint

    t = synth_checkpoint(cfg, rng)
    for name, arr in t.items():
        if arr.ndim >= 2:  # weights; 1-D norms and biases stay as drawn
            t[name] = arr * (2.0 / np.sqrt(arr.shape[-1]))
    t[N.FINAL_NORM] = np.abs(t[N.FINAL_NORM]) * 4.0 + 1.0
    return t


def _q4_names(cfg: VoxtralConfig) -> set:
    names = {N.TOK_EMBEDDINGS} | set(N.adapter_names().values())
    for i in range(cfg.audio_encoder.n_layers):
        nm = N.encoder_layer_names(i)
        names |= {nm[x] for x in ("wq_weight", "wk_weight", "wv_weight",
                                  "wo_weight", "w1_weight", "w2_weight",
                                  "w3_weight")}
    for i in range(cfg.language_model.n_layers):
        nm = N.decoder_layer_names(i)
        names |= {nm[x] for x in ("ada_norm_down", "ada_norm_up",
                                  "wq_weight", "wk_weight", "wv_weight",
                                  "wo_weight", "w1_weight", "w2_weight",
                                  "w3_weight")}
    return names


@pytest.fixture(scope="module")
def gguf_file(tmp_path_factory):
    cfg = gguf_cfg()
    q4 = _q4_names(cfg)
    tensors = {}
    for name, arr in _tensors(cfg, np.random.default_rng(5)).items():
        if name in q4 and arr.shape[-1] % 32 == 0:
            tensors[name] = (arr.shape, GGML_Q4_0, quantize_q4_0(arr))
        else:
            tensors[name] = (arr.shape, GGML_F32,
                             arr.astype(np.float32).tobytes())
    d = tmp_path_factory.mktemp("gguf")
    path = d / "tiny_q4.gguf"
    with open(path, "wb") as f:
        write_gguf(f, tensors)
    (d / "tekken.json").write_text(tekken_json())
    return cfg, path


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("fmt", ["q4", "q4g", "w8"])
def test_loader_trees_equal_jax(gguf_file, fmt):
    from voxtral_tpu.loaders.gguf_loader import Q4ModelLoader as JLoader
    from voxtral_tpu_torch.loaders.gguf_loader import Q4ModelLoader

    cfg, path = gguf_file
    tcfg = _port_cfg(cfg)
    got = dict(_leaves(Q4ModelLoader.from_file(
        path, cfg=tcfg, weight_format=fmt).load_numpy()))
    ref = dict(_leaves(JLoader.from_file(
        path, cfg=cfg, weight_format=fmt).load(to_device=False)))
    assert set(got) == set(ref)
    for name in ref:
        g, r = np.asarray(got[name]), np.asarray(ref[name])
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(
            np.ascontiguousarray(g).view(np.uint8),
            np.ascontiguousarray(r).view(np.uint8), err_msg=name)
    packed = [n for n in got if n.endswith("codes_packed")]
    if fmt == "q4":
        assert any("layers/attention/wq" in n for n in packed)
        assert "/decoder/tok_embeddings/q4/codes_packed" in got
    else:
        assert not packed
    # The device tree goes through params_from_numpy.
    tree = Q4ModelLoader.from_file(path, cfg=tcfg,
                                   weight_format=fmt).load("cpu")
    assert str(next(iter(dict(_leaves(tree)).values())).device) == "cpu"


def _port_cfg(cfg: VoxtralConfig):
    from voxtral_tpu_torch.config import VoxtralConfig as TConfig

    return TConfig.from_json(cfg.to_params_json())


@pytest.fixture(scope="module")
def jax_tokens(gguf_file):
    """JAX tokens per route, with the env read at model construction."""
    from voxtral_tpu.loaders.gguf_loader import load_q4_model

    cfg, path = gguf_file
    mel = test_mel()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        for fmt in ("q4", "q4g"):
            model = load_q4_model(path, cfg, weight_format=fmt)
            assert model.megakernel_weights == (None if fmt == "q4"
                                                else "q4g")
            out[fmt] = model.transcribe_streaming(mel)
        out["q4g_spec"] = model.transcribe_streaming(mel, speculative=4)
    return out


@pytest.mark.parametrize("fmt", ["q4", "q4g"])
def test_transcribe_tokens_equal_jax(gguf_file, jax_tokens, fmt):
    from voxtral_tpu_torch.loaders.gguf_loader import load_q4_model
    from voxtral_tpu_torch.ops import q4_kernel as k3

    cfg, path = gguf_file
    model = load_q4_model(path, _port_cfg(cfg), weight_format=fmt,
                          device="cpu")
    assert model.decode_route == ("per_op" if fmt == "q4" else "q4g")
    model.record_margins = True
    tokens = model.transcribe_streaming(test_mel())
    margin = float(model.last_margins.min())
    assert margin > MIN_MARGIN, f"near-tie: top-2 margin {margin:.4f}"
    assert len(set(tokens.tolist())) > 1  # not a constant stream
    assert tokens.tolist() == jax_tokens[fmt].tolist()
    if fmt == "q4g":
        spec = model.transcribe_streaming(test_mel(), speculative=4)
        assert model.last_spec_passes >= 1
        assert spec.tolist() == jax_tokens["q4g_spec"].tolist()
        assert spec.tolist() == tokens.tolist()
    else:
        # Speculative decode rides the sequential loop on the per-op
        # route, as JAX gates it on the fused step.
        assert model.transcribe_streaming(
            test_mel(), speculative=4).tolist() == tokens.tolist()
        assert model.last_spec_passes == 0
        assert k3.q4_matmul_packed.launches == 0  # CPU: the plain version


def test_q4g_stacks_over_a_packed_table_match_jax(gguf_file, monkeypatch):
    """q4g layers with a packed (q4) table: the stack step runs in g32
    mode without the lm fold, the lm_head after it (K3), as in JAX."""
    from voxtral_tpu.loaders.gguf_loader import Q4ModelLoader as JLoader
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, path = gguf_file
    tree = JLoader.from_file(path, cfg=cfg,
                             weight_format="q4g").load(to_device=False)
    packed = JLoader.from_file(path, cfg=cfg,
                               weight_format="q4").load(to_device=False)
    tree["decoder"]["tok_embeddings"] = packed["decoder"]["tok_embeddings"]
    model = VoxtralModel.from_numpy(tree, _port_cfg(cfg), "cpu")
    assert model.decode_route == "q4g"
    assert "lm_codes" not in model.fused_decode
    model.record_margins = True
    tokens = model.transcribe_streaming(test_mel())
    assert float(model.last_margins.min()) > MIN_MARGIN
    monkeypatch.setenv("VOXTRAL_MEGAKERNEL", "force")
    jmodel = JaxModel(jax.tree_util.tree_map(jnp.asarray, tree), cfg)
    assert jmodel.megakernel_weights == "q4g"
    assert tokens.tolist() == jmodel.transcribe_streaming(test_mel()).tolist()


def test_from_gguf_reads_the_sidecar_params_json(gguf_file, tmp_path):
    from voxtral_tpu_torch.audio import AudioBuffer, save_wav
    from voxtral_tpu_torch.pipeline import PipelineConfig, TranscribePipeline

    cfg, path = gguf_file
    with pytest.raises(KeyError):
        # No params.json beside the file: production defaults, whose
        # shapes the tiny checkpoint does not have.
        TranscribePipeline.from_gguf(path, path.parent / "tekken.json",
                                     device="cpu")
    (path.parent / "params.json").write_text(cfg.to_params_json())
    try:
        pipe = TranscribePipeline.from_gguf(
            path, path.parent / "tekken.json", PipelineConfig(),
            weight_format="q4g", device="cpu")
    finally:
        (path.parent / "params.json").unlink()
    assert pipe.model.config.language_model.dim == 256
    assert pipe.model.decode_route == "q4g"
    t = np.arange(24000) / 16000
    wav = tmp_path / "tone.wav"
    save_wav(AudioBuffer((0.4 * np.sin(2 * np.pi * 440 * t)).astype(
        np.float32), 16000), wav)
    text = pipe.transcribe_file(wav)
    assert isinstance(text, str)
    # params_cache: the first load builds and saves the converted tree,
    # the second reads it back; both give the same text.
    cache = tmp_path / "cache"
    for _ in range(2):
        cached = TranscribePipeline.from_gguf(
            path, path.parent / "tekken.json", config=_port_cfg(cfg),
            weight_format="q4g", device="cpu", params_cache=cache)
        assert cached.model.decode_route == "q4g"
        assert cached.transcribe_file(wav) == text
    assert len(list(cache.glob("*.json"))) == 1


def test_cli_gguf_end_to_end(gguf_file, tmp_path, capsys):
    from voxtral_tpu_torch import cli
    from voxtral_tpu_torch.audio import AudioBuffer, save_wav
    from voxtral_tpu_torch.pipeline import TranscribePipeline

    cfg, path = gguf_file
    params = tmp_path / "params.json"
    params.write_text(cfg.to_params_json())
    t = np.arange(24000) / 22050
    wav = tmp_path / "tone.wav"
    save_wav(AudioBuffer((0.4 * np.sin(2 * np.pi * 440 * t)).astype(
        np.float32), 22050), wav)
    tok = str(path.parent / "tekken.json")
    rc = cli.main(["--gguf", str(path), "--tokenizer", tok, "--params",
                   str(params), "--weight-format", "q4g", "--device", "cpu",
                   "--audio", str(wav)])
    out = capsys.readouterr().out
    assert rc == 0 and len(out.splitlines()) == 1
    lib = TranscribePipeline.from_gguf(path, tok, config=_port_cfg(cfg),
                                       weight_format="q4g", device="cpu")
    assert out == lib.transcribe_file(wav) + "\n"
    # --gguf needs --tokenizer; a missing file and a corrupt one exit 2.
    assert cli.main(["--gguf", str(path), "--device", "cpu",
                     "--audio", str(wav)]) == 2
    assert "--gguf requires --tokenizer" in capsys.readouterr().err
    assert cli.main(["--gguf", str(tmp_path / "none.gguf"), "--tokenizer",
                     tok, "--device", "cpu", "--audio", str(wav)]) == 2
    bad = tmp_path / "bad.gguf"
    bad.write_bytes(b"XXXX" + bytes(60))
    assert cli.main(["--gguf", str(bad), "--tokenizer", tok, "--device",
                     "cpu", "--audio", str(wav)]) == 2
    assert "failed to load GGUF model" in capsys.readouterr().err
