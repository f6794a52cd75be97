"""The port's SafeTensors loader, parameter cache, ``from_model_dir`` and
CLI ``--model`` / ``--dtype`` / ``--params-cache`` against the JAX
package.

A tiny model directory (consolidated.safetensors, params.json,
tekken.json) is written by the test itself from the dense tree of
``tests/test_torch_model.py`` (the same margin-robust configuration), in
f32 and in bf16.  The loaders must agree leaf for leaf (exactly: both
read the same bytes and round f32 to bf16 to nearest even); the
pipelines built from the directory must give JAX's tokens for bfloat16,
float32 and w8; a cache entry written by either package must be read by
the other.
"""

import numpy as np
import pytest

import jax
import ml_dtypes
import torch

from tests.test_torch_model import (
    FINAL_NORM_GAIN,
    MIN_MARGIN,
    SCALE,
    SEED,
    dense_params,
    tiny_config,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_pipeline import tekken_json
from voxtral_tpu_torch.config import VoxtralConfig
from voxtral_tpu_torch.loaders import safetensors_loader as tst

BF16 = np.dtype(ml_dtypes.bfloat16)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _assert_trees_equal(got, ref):
    g, r = _leaves(got), _leaves(ref)
    assert set(g) == set(r)
    for key in r:
        ga, ra = g[key], r[key]
        want = str(np.asarray(ra).dtype)
        have = (str(ga.dtype).removeprefix("torch.")
                if isinstance(ga, torch.Tensor) else str(ga.dtype))
        assert have == want, key
        assert tuple(ga.shape) == tuple(np.asarray(ra).shape), key
        np.testing.assert_array_equal(_as_f32(ga), _as_f32(ra), err_msg=key)


def write_model_dir(directory, dtype: str = "float32"):
    """The tiny dense model as a SafeTensors model directory in ``dtype``
    (the checkpoint's storage type) -> (directory, port config)."""
    cfg = tiny_config()
    tree = dense_params(cfg, SEED, SCALE, FINAL_NORM_GAIN)
    tensors = tst.checkpoint_tensors(tree, cfg)
    if dtype == "bfloat16":
        tensors = {k: np.asarray(v).astype(BF16) for k, v in tensors.items()}
    directory.mkdir(parents=True, exist_ok=True)
    tst.save_safetensors(tensors, directory / "consolidated.safetensors")
    (directory / "params.json").write_text(cfg.to_params_json())
    (directory / "tekken.json").write_text(tekken_json())
    return directory, VoxtralConfig.from_file(directory / "params.json")


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    return {dt: write_model_dir(root / dt, dt)[0]
            for dt in ("float32", "bfloat16")}


@pytest.mark.parametrize("stored", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loader_matches_jax_leaf_by_leaf(model_dirs, stored, dtype):
    """Both loaders on one file: the same tree, leaf for leaf, whether
    the checkpoint holds f32 or bf16 and whichever dtype is asked for;
    the numpy tree (``to_device=False``) is JAX's too."""
    from voxtral_tpu.config import VoxtralConfig as JaxConfig
    from voxtral_tpu.loaders.safetensors_loader import (
        load_voxtral_params as jax_load,
    )

    path = model_dirs[stored] / "consolidated.safetensors"
    cfg = VoxtralConfig.from_file(model_dirs[stored] / "params.json")
    jcfg = JaxConfig.from_file(model_dirs[stored] / "params.json")
    ref = jax_load(path, jcfg, dtype=dtype, to_device=False)
    got = tst.load_voxtral_params(path, cfg, dtype, device="cpu")
    assert got["decoder"]["layers"]["attention"]["wq"].is_contiguous()
    _assert_trees_equal(got, ref)
    _assert_trees_equal(tst.load_voxtral_params(path, cfg, dtype,
                                                to_device=False), ref)


def test_reader_writer_and_vocab_truncation(model_dirs, tmp_path):
    """The port's writer is read by the safetensors package and the
    package's files by the port; the table can be cut to its leading
    rows, as JAX does."""
    from safetensors.numpy import load_file, save_file

    from voxtral_tpu.loaders import names as N
    from voxtral_tpu.loaders.safetensors_loader import (
        load_voxtral_params as jax_load,
    )
    from voxtral_tpu.config import VoxtralConfig as JaxConfig

    path = model_dirs["float32"] / "consolidated.safetensors"
    lib = load_file(str(path))
    st = tst.SafeTensorsFile(path)
    assert sorted(st.names()) == sorted(lib)
    for name in (N.TOK_EMBEDDINGS, N.FINAL_NORM):
        np.testing.assert_array_equal(st.tensor(name), lib[name])
        assert st.tensor_meta(name) == ("F32", lib[name].shape)
    other = tmp_path / "lib.safetensors"
    save_file(lib, str(other))
    back = tst.SafeTensorsFile(other)
    for name in lib:
        np.testing.assert_array_equal(back.raw(name), lib[name])
    with pytest.raises(KeyError):
        st.raw("missing.weight")
    cfg = VoxtralConfig.from_file(model_dirs["float32"] / "params.json")
    jcfg = JaxConfig.from_file(model_dirs["float32"] / "params.json")
    got = tst.load_voxtral_params(path, cfg, "float32", max_vocab_size=1000,
                                  device="cpu")
    ref = jax_load(path, jcfg, dtype="float32", max_vocab_size=1000,
                   to_device=False)
    assert got["decoder"]["tok_embeddings"].shape == (1000, 64)
    _assert_trees_equal(got, ref)
    # The checkpoint round-trips through the inverse of the loader.
    tree = dense_params(tiny_config(), SEED, SCALE, FINAL_NORM_GAIN)
    _assert_trees_equal(tst.load_voxtral_params(path, cfg, "float32",
                                                device="cpu"), tree)


@pytest.fixture(scope="module")
def jax_pipeline_tokens(model_dirs):
    """JAX's ``from_model_dir`` chunk tokens per dtype (the bf16 model on
    its fused step, in interpret mode)."""
    from voxtral_tpu.audio import AudioBuffer
    from voxtral_tpu.pipeline import TranscribePipeline as JaxPipeline

    sig = _tone()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        for dtype in ("bfloat16", "float32", "w8"):
            pipe = JaxPipeline.from_model_dir(model_dirs["float32"], dtype)
            _, chunks = pipe._chunk_tokens(AudioBuffer(sig, 16000).samples,
                                           16000)
            out[dtype] = [np.asarray(c) for c in chunks]
    return out


def _tone() -> np.ndarray:
    t = np.arange(int(1.5 * 16000)) / 16000
    return (0.4 * np.sin(2 * np.pi * 440 * t)
            + 0.2 * np.sin(2 * np.pi * 1320 * t)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "w8"])
def test_from_model_dir_tokens_equal_jax(model_dirs, jax_pipeline_tokens,
                                         dtype):
    from voxtral_tpu_torch.pipeline import TranscribePipeline

    pipe = TranscribePipeline.from_model_dir(model_dirs["float32"], dtype,
                                             device="cpu")
    route = {"bfloat16": "bf16", "float32": "per_op", "w8": "w8"}[dtype]
    assert pipe.model.decode_route == route
    pipe.model.record_margins = True
    chunks = pipe._chunk_tokens(_tone(), 16000)
    assert float(pipe.model.last_margins.min()) > MIN_MARGIN
    assert len(set(np.concatenate(chunks).tolist())) > 1
    assert [c.tolist() for c in chunks] == [
        c.tolist() for c in jax_pipeline_tokens[dtype]]
    assert pipe.tokenizer.decode([1004, 1005]) == "w0 w1 "
    with pytest.raises(ValueError, match="dtype"):
        TranscribePipeline.from_model_dir(model_dirs["float32"], "q4",
                                          device="cpu")


def test_param_cache_crosses_packages(model_dirs, tmp_path):
    """A w8 entry written by the JAX package is found and read by the
    port, one written by the port by JAX: the same key, files and
    leaves; a bf16 tree (raw uint16 words) crosses the same way."""
    from voxtral_tpu.loaders import param_cache as jpc
    from voxtral_tpu_torch.loaders import param_cache as tpc
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    src = model_dirs["float32"] / "consolidated.safetensors"
    cfg = VoxtralConfig.from_file(model_dirs["float32"] / "params.json")

    def build():
        return quantize_params_w8(tst.load_voxtral_params(
            src, cfg, "float32", to_device=False))

    ref = build()
    assert tpc.cache_entry(tmp_path, src, "w8") == jpc.cache_entry(
        tmp_path, src, "w8")
    jpc.load_or_build(tmp_path / "jax", src, "w8", build, to_device=False)

    def never():
        raise AssertionError("the entry should have been found")

    got = tpc.load_or_build(tmp_path / "jax", src, "w8", never, "cpu")
    _assert_trees_equal(got, ref)
    tpc.load_or_build(tmp_path / "port", src, "w8", build, "cpu")
    back = jpc.load_or_build(tmp_path / "port", src, "w8", never,
                             to_device=False)
    _assert_trees_equal(back, ref)
    # bf16 leaves, tensors in, both ways.
    dense = tst.load_voxtral_params(src, cfg, "bfloat16", device="cpu")
    tpc.save_params(dense, tmp_path / "dense")
    _assert_trees_equal(dense, jpc.load_params(tmp_path / "dense",
                                               to_device=False))
    jpc.save_params(jax.tree_util.tree_map(np.asarray, jpc.load_params(
        tmp_path / "dense", to_device=False)), tmp_path / "dense_j")
    _assert_trees_equal(tpc.load_params(tmp_path / "dense_j", "cpu"),
                        jpc.load_params(tmp_path / "dense", to_device=False))
    # A partial entry is a miss, rebuilt.
    base = tpc.cache_entry(tmp_path / "broken", src, "w8")
    base.parent.mkdir()
    (base.parent / (base.name + ".json")).write_text("{")
    (base.parent / (base.name + ".npd")).mkdir()
    calls = []
    tpc.load_or_build(tmp_path / "broken", src, "w8",
                      lambda: calls.append(1) or build(), "cpu")
    assert calls == [1]


def test_model_paths_and_download_stay_lazy(tmp_path, model_dirs):
    from voxtral_tpu_torch import hub

    paths = hub.ModelPaths.from_dir(model_dirs["float32"])
    assert paths.weights.name == "consolidated.safetensors"
    with pytest.raises(FileNotFoundError, match="tekken.json"):
        (tmp_path / "consolidated.safetensors").write_bytes(b"")
        (tmp_path / "params.json").write_text("{}")
        hub.ModelPaths.from_dir(tmp_path)
    assert hub.DEFAULT_REPO == "mistralai/Voxtral-Mini-4B-Realtime-2602"


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    from voxtral_tpu_torch.audio import AudioBuffer, save_wav

    path = tmp_path_factory.mktemp("audio") / "tone.wav"
    save_wav(AudioBuffer(_tone(), 16000), path)
    return path


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "w8"])
def test_cli_model_dir(model_dirs, wav, dtype, capsys, tmp_path):
    """``--model DIR --dtype ... --device cpu`` prints the library path's
    text; ``--params-cache`` (w8) gives the same text cold and warm."""
    from voxtral_tpu_torch import cli
    from voxtral_tpu_torch.pipeline import TranscribePipeline

    argv = ["--model", str(model_dirs["bfloat16"]), "--dtype", dtype,
            "--device", "cpu", "--audio", str(wav)]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    lib = TranscribePipeline.from_model_dir(
        model_dirs["bfloat16"], dtype, device="cpu").transcribe_file(wav)
    assert out == lib + "\n" and lib.strip()
    if dtype == "w8":
        for _ in range(2):
            assert cli.main([*argv, "--params-cache", str(tmp_path)]) == 0
            assert capsys.readouterr().out == out
        assert len(list(tmp_path.glob("*.json"))) == 1


def test_cli_random_dense_weights_and_errors(wav, capsys, tmp_path):
    from voxtral_tpu_torch import cli

    for dtype in ("bfloat16", "float32"):
        rc = cli.main(["--random-weights", "--dtype", dtype, "--device",
                       "cpu", "--params", "tests/fixtures/params_tiny.json",
                       "--audio", str(wav)])
        assert rc == 0
        assert len(capsys.readouterr().out.splitlines()) == 1
    assert cli.main(["--audio", str(wav)]) == 2
    assert "--model DIR" in capsys.readouterr().err
    assert cli.main(["--model", str(tmp_path), "--device", "cpu",
                     "--audio", str(wav)]) == 2
    assert "consolidated.safetensors" in capsys.readouterr().err


def test_random_dense_params_shapes_and_bytes():
    """The device-built random tree: JAX's init_random shapes and
    dtypes, seeded draws of scale 0.02, zero biases, unit norms."""
    from voxtral_tpu.models.adapter import init_adapter_params
    from voxtral_tpu.models.decoder import init_decoder_params
    from voxtral_tpu.models.encoder import init_encoder_params
    from voxtral_tpu_torch.utils.hbm import tree_unique_bytes
    from voxtral_tpu_torch.utils.quantize import random_dense_params

    cfg = tiny_config()
    tree = random_dense_params(cfg, 3, torch.bfloat16, "cpu")
    key = jax.random.PRNGKey(0)
    ref = {"encoder": jax.eval_shape(lambda: init_encoder_params(
               key, cfg.audio_encoder)),
           "decoder": jax.eval_shape(lambda: init_decoder_params(
               key, cfg.language_model, cfg.ada_rms_norm_t_cond_dim)),
           "adapter": jax.eval_shape(lambda: init_adapter_params(
               key, cfg.adapter.input_dim, cfg.language_model.dim,
               cfg.adapter.output_dim))}
    got, want = _leaves(tree), _leaves(ref)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == torch.bfloat16, k
    w = got["decoder.layers.ffn.w1"].float()
    assert abs(w.std().item() - 0.02) < 2e-3
    assert got["encoder.layers.attention.wq_b"].abs().max() == 0
    assert torch.equal(got["decoder.norm"].float(),
                       torch.ones(cfg.language_model.dim))
    again = random_dense_params(cfg, 3, torch.bfloat16, "cpu")
    assert torch.equal(again["decoder"]["tok_embeddings"],
                       tree["decoder"]["tok_embeddings"])
    n = sum(int(np.prod(v.shape)) for v in want.values())
    assert tree_unique_bytes(tree) == 2 * n
    f32 = random_dense_params(cfg, 3, torch.float32, "cpu")
    assert tree_unique_bytes(f32) == 4 * n
