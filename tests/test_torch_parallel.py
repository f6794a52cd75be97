"""The meshed one-shot path end to end: the port on a mesh of CPUs
against the JAX package on its 8-device virtual mesh.

Model: the tiny margin-robust w8 model of ``tests/test_torch_model.py``
(2 layers, dim 64, 4 query / 2 KV heads, hidden 128, vocab 1280), so
tp = 2 shards hold 2 query heads, 1 KV head, 64 FFN rows and 640 vocab
rows.  Two rows: the 1.5 s tone and 0.8 of it, which decode to other
tokens (a row mixed up between data groups shows) with every top-2
margin above 0.28.  (At 0.9 the port parts from JAX on one device
already, at a margin of 0.12: the encoder's ``lax.scan`` roundings,
``tests/test_torch_model.py``'s docstring; no mesh is involved.)  The
JAX side is ``VoxtralModel(mesh=make_mesh(...))`` under
``VOXTRAL_MEGAKERNEL=force``: its TP halves and DP ``shard_map`` in
interpret mode, the encoder and prefill GSPMD-partitioned; the port runs
those whole on the mesh's first device and the decode per shard.

Tokens must be identical at tp = 2, dp = 2 and 2 x 2, sequential and
speculative K = 4 (the port's speculative == its sequential); every
top-2 margin of the port's runs is above ``MIN_MARGIN``, so a flip could
be told from a fault.  The JAX references are computed once per module.
Also here: ``make_mesh``, the meshed path's refusals and the CLI's
``--tp`` / ``--dp`` on ``--device cpu``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_model import (
    FINAL_NORM_GAIN, MIN_MARGIN, SCALE, SEED, dense_params, test_mel,
    tiny_config,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from voxtral_tpu_torch.parallel import make_mesh

MESHES = [(1, 2), (2, 1), (2, 2)]  # (data, model)
SPEC_K = 4

requires_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def setup():
    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    cfg = tiny_config()
    tree = quantize_params_w8(dense_params(cfg, SEED, SCALE, FINAL_NORM_GAIN))
    mel = test_mel()
    return cfg, tree, mel, np.concatenate([mel, mel * 0.8])


@pytest.fixture(scope="module")
def jax_tokens(setup):
    """{(data, model): (sequential, speculative K)} of the two-row batch,
    and "pad": dp = 2 on one row (padded to two, JAX ``_pad_dp_rows``)."""
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu.parallel import make_mesh as jax_make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    cfg, tree, mel, mel2 = setup
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        for nd, nm in MESHES:
            m = JaxModel(jtree, cfg, mesh=jax_make_mesh(nd, nm))
            out[(nd, nm)] = (m.transcribe_streaming_batch(mel2),
                             m.transcribe_streaming_batch(
                                 mel2, speculative=SPEC_K))
            if (nd, nm) == (2, 1):
                out["pad"] = m.transcribe_streaming(mel)
    return out


def _model(setup, nd, nm, **kw):
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, tree = setup[0], setup[1]
    return VoxtralModel.from_numpy(
        tree, cfg, mesh=make_mesh(nd, nm, ["cpu"] * (nd * nm)), **kw)


def test_make_mesh_shape_refusal_and_repeated_devices():
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices == [[torch.device("cpu")] * 2] * 2
    assert mesh.first == torch.device("cpu")
    with pytest.raises(ValueError, match="Mesh needs 8 devices, only 4"):
        make_mesh(4, 2, ["cpu"] * 4)
    with pytest.raises(ValueError, match="must be >= 1"):
        make_mesh(0, 2, ["cpu"] * 4)
    # By default every card: there is none here.
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"Mesh needs {n + 1} devices"):
        make_mesh(1, n + 1)


@requires_8_devices
@pytest.mark.parametrize("nd,nm", MESHES)
def test_meshed_tokens_match_jax(setup, jax_tokens, nd, nm):
    mel2 = setup[3]
    model = _model(setup, nd, nm)
    model.record_margins = True
    seq = model.transcribe_streaming_batch(mel2)
    assert model.last_decode_route == ("tp" if nm > 1 else "dp")
    assert float(model.last_margins.min()) > MIN_MARGIN
    assert model.last_margins.shape == seq.shape
    model.record_margins = False
    spec = model.transcribe_streaming_batch(mel2, speculative=SPEC_K)
    assert 0 < model.last_spec_passes < seq.shape[1]
    ref_seq, ref_spec = jax_tokens[(nd, nm)]
    assert seq.tolist() == ref_seq.tolist()
    assert spec.tolist() == ref_spec.tolist() == seq.tolist()


@requires_8_devices
def test_dp_pads_rows_as_jax(setup, jax_tokens):
    """One row on dp = 2: a zero mel row pads the batch, its tokens are
    trimmed, the row's tokens those of JAX (and of the two-row batch)."""
    model = _model(setup, 2, 1)
    got = model.transcribe_streaming(setup[2])
    assert got.tolist() == np.asarray(jax_tokens["pad"]).tolist()
    assert got.tolist() == jax_tokens[(2, 1)][0][0].tolist()
    tokens = model.transcribe_streaming_batch_async(setup[2])
    assert tuple(tokens.shape) == (1, got.shape[0])


def test_meshed_model_layout_and_refusals(setup, monkeypatch):
    from voxtral_tpu_torch import StreamingSession, StreamPool
    from voxtral_tpu_torch.models import voxtral as tvx
    from voxtral_tpu_torch.utils.hbm import HBMBudgetError
    from voxtral_tpu_torch.utils.quantize import random_dense_params

    cfg = setup[0]
    tp = _model(setup, 1, 2)
    assert tp.fused_decode is None  # JAX drops the single-device stacks
    # The placed shards only: one data group of two model shards.
    assert len(tp.fused_tp["wqkv"]) == 1 and len(tp.fused_tp["wqkv"][0]) == 2
    assert tp.fused_tp["lm_codes"][0][1].shape == (640, 64)
    dp = _model(setup, 2, 1)
    assert dp.fused_decode is not None and dp.fused_tp is None
    # Sessions and pools take the meshed routes: the TP halves on a tp
    # mesh, K1 per data group on a dp one (tests/test_torch_mesh_stream.py).
    assert StreamingSession(tp)._tp_mesh is not None
    assert StreamPool(dp, max_streams=2)._dp_mesh is not None
    with pytest.raises(ValueError, match="ROADMAP item 12.3b"):
        tvx.VoxtralModel(random_dense_params(cfg, 0, torch.bfloat16, "cpu"),
                         cfg, mesh=make_mesh(1, 2, ["cpu"] * 2))
    with pytest.raises(ValueError, match="tp=4 must divide n_kv=2"):
        _model(setup, 1, 4)
    with pytest.raises(ValueError, match="first device"):
        _model_on(setup, "meta")
    route, why = tvx.oneshot_plan(tp, 2, 400, spec=8)
    assert route == "tp" and "fit" in why
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(2 ** 20))
    with pytest.raises(HBMBudgetError, match="no decode route takes .* "
                       "2 mesh -- tp"):
        tvx.oneshot_plan(tp, 2, 400)


@pytest.mark.parametrize("nd,nm", [(1, 2), (2, 2)])
def test_meshed_oneshot_admission_counts_the_first_device_whole(
        setup, monkeypatch, nd, nm):
    """``oneshot_plan``'s mesh rung holds the mesh's first device to its
    whole load: its weights, its shard's head-major copy of its data
    group's rows, and the full prefill cache, which no shard divides.
    At one byte less the batch is refused with ``HBMBudgetError`` (a
    count that divided the prefill cache over the shards would admit it
    and fail out of memory in the decode)."""
    from voxtral_tpu_torch.models import voxtral as tvx
    from voxtral_tpu_torch.utils import hbm

    model = _model(setup, nd, nm)
    batch, seq_len = 4, 400
    copy = tvx.oneshot_cache_bytes(model, batch // nd, seq_len) // nm
    need = (hbm.shard_weight_bytes(model, 0, 0) + copy + hbm.WORKSPACE_BYTES
            + tvx.oneshot_cache_bytes(model, batch, seq_len))
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(need))
    assert tvx.oneshot_plan(model, batch, seq_len)[0] == "tp"
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(need - 1))
    with pytest.raises(hbm.HBMBudgetError,
                       match=r"mesh shard \(0, 0\)"):
        tvx.oneshot_plan(model, batch, seq_len)


def test_place_shards_views_on_a_shared_device_copies_across():
    """On one device the shards are views of the stacked leaf; over
    devices of their own each shard is its own tensor, so the stacked
    leaf (on the first device) can be freed."""
    from voxtral_tpu_torch.ops.decode_tp import place_shards

    leaf = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    base = leaf.untyped_storage().data_ptr()
    shared = place_shards(make_mesh(2, 2, ["cpu"] * 4), {"w": leaf})["w"]
    assert [[t.untyped_storage().data_ptr() for t in row] for row in shared] \
        == [[base, base], [base, base]]
    apart = place_shards(make_mesh(1, 2, ["cpu", "meta"]), {"w": leaf})["w"]
    assert apart[0][0].untyped_storage().data_ptr() != base
    assert torch.equal(apart[0][0], leaf[0])
    assert apart[0][1].device.type == "meta"
    with pytest.raises(ValueError, match="3 shards for a mesh of 2"):
        place_shards(make_mesh(1, 2, ["cpu"] * 2),
                     {"w": torch.zeros(3, 2)})


def _model_on(setup, device):
    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    return VoxtralModel(params_from_numpy(setup[1], "cpu"), setup[0], "cpu",
                        mesh=make_mesh(1, 2, [device] * 2))


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    from voxtral_tpu_torch.audio import AudioBuffer, save_wav

    sr = 16000
    t = np.arange(int(1.5 * sr)) / sr
    sig = (0.4 * np.sin(2 * np.pi * 440 * t)
           + 0.2 * np.sin(2 * np.pi * 1320 * t)).astype(np.float32)
    path = tmp_path_factory.mktemp("audio") / "tone.wav"
    save_wav(AudioBuffer(sig, sr), path)
    return path


def test_cli_tp_dp_on_cpu(wav, capsys):
    """``--tp`` / ``--dp`` with ``--device cpu``: the mesh repeats the
    CPU; dp gives the single-device text (DP is exact); tp runs; values
    below 1 exit 2."""
    from voxtral_tpu_torch import cli

    base = ["--random-weights", "--dtype", "w8", "--device", "cpu",
            "--params", "tests/fixtures/params_tiny.json", "--audio",
            str(wav)]
    outs = {}
    for extra in ([], ["--dp", "2"], ["--tp", "2"], ["--tp", "2", "--dp",
                                                      "2"]):
        assert cli.main(base + extra) == 0, extra
        outs[tuple(extra)] = capsys.readouterr().out
    assert outs[("--dp", "2")] == outs[()]
    assert all(len(o.splitlines()) == 1 for o in outs.values())
    assert cli.main(base + ["--tp", "0"]) == 2
    assert "--tp/--dp must be >= 1" in capsys.readouterr().err
    assert cli.main(base + ["--dtype", "bfloat16", "--tp", "2"]) == 2
    assert "ROADMAP item 12.3b" in capsys.readouterr().err


@pytest.mark.cuda
@pytest.mark.parametrize("nd,nm", MESHES)
def test_meshed_kernels_match_plain_on_card(setup, nd, nm):
    """On one card (the shards share it): the kernels' tokens == the plain
    versions' on every mesh, and DP == the single-card batch exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, tree, _, mel2 = setup
    mesh = make_mesh(nd, nm, ["cuda:0"] * (nd * nm))
    got = VoxtralModel.from_numpy(tree, cfg, mesh=mesh)
    plain = VoxtralModel.from_numpy(tree, cfg, mesh=mesh, kernels=False)
    seq = got.transcribe_streaming_batch(mel2)
    assert seq.tolist() == plain.transcribe_streaming_batch(mel2).tolist()
    assert got.transcribe_streaming_batch(
        mel2, speculative=SPEC_K).tolist() == seq.tolist()
    if nm == 1:
        one = VoxtralModel.from_numpy(tree, cfg, "cuda:0")
        assert one.transcribe_streaming_batch(mel2).tolist() == seq.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("nd,nm", MESHES)
def test_meshed_tokens_on_cards_of_their_own(setup, nd, nm):
    """Each shard on a card of its own (``make_mesh`` over the cards):
    the shards' weights lie on their cards, and the tokens equal those of
    the mesh of the same shape whose shards share card 0, sequential and
    speculative."""
    n = nd * nm
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPUs: a mesh over cards of their own")
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, tree, _, mel2 = setup
    mesh = make_mesh(nd, nm)
    apart = VoxtralModel.from_numpy(tree, cfg, mesh=mesh)
    placed = apart.fused_tp["wqkv"] if nm > 1 else apart._dp_stacks["wqkv"]
    where = ([[t.device for t in row] for row in placed] if nm > 1
             else [[t.device] for t in placed])
    assert where == mesh.devices
    seq = apart.transcribe_streaming_batch(mel2)
    assert apart.transcribe_streaming_batch(
        mel2, speculative=SPEC_K).tolist() == seq.tolist()
    shared = VoxtralModel.from_numpy(
        tree, cfg, mesh=make_mesh(nd, nm, ["cuda:0"] * n))
    assert shared.transcribe_streaming_batch(mel2).tolist() == seq.tolist()

