"""Dense bf16 models on a data-parallel mesh: K1 mode (i) over the bf16
table, and the one-shot path, a solo session and a pool at dp = 2,
against the JAX package.

K1 (i) over a bf16 table: the stacks and rows of
``tests/test_torch_dense.py`` (3 layers, D 256, vocab 1024) go through
JAX's ``decode_stack_step(lm_argmax=True)`` on its mode (g) stacks
(Pallas, interpret mode) and the port's plain version.  Each row's
winning table row is planted (3 |h| times the row's final-norm direction,
so the winner's logit leads the next by far more than the 1e-2 of the
largest value the two packages' f32 / f64 sums may move it); some
winners have a twin: the same bf16 row at another index, in another of
JAX's 512-row tiles, where the lower index must win.  Tokens are equal,
with no tolerance: identical rows give identical logits in both
packages.

End to end: the tiny model of ``tests/test_torch_model.py`` in bf16.
JAX decodes a meshed bf16 model through its GSPMD-partitioned XLA step
(``voxtral_tpu/models/voxtral.py:824-826``); the port runs K1 (g) per
data group, its greedy tokens from K1 (i).  Tokens are equal on
margin-robust inputs: every top-2 margin of the port's runs is above
``MIN_MARGIN``, far above the 1e-2 of the largest value within which
K1 (g)'s plain version meets JAX (``tests/test_torch_dense.py``).  dp = 2 equals the port's single device
exactly.  Also here: the refusals that remain (ROADMAP item 12.3b), the
CLI, the vocabulary a tp mesh does not split, and the ``cuda`` tests
(K1 (i) over bf16 kernel == plain at 1, 8 and 12 rows with ties; the
dp = 2 model's kernels == plain).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from tests.test_torch_dense import (
    EPS, HEAD_DIM, N_HEADS, N_KV, SESSION_SIGNALS, V, _rows, build_inputs,
    to_torch,
)
from tests.test_torch_model import (
    FINAL_NORM_GAIN, MIN_MARGIN, SCALE, SEED, dense_params, test_mel,
    tiny_config,
)
from tests.test_torch_model import one_torch_thread  # noqa: F401  (autouse)
from voxtral_tpu.ops import decode_step_pallas as jdsp
from voxtral_tpu_torch import convert
from voxtral_tpu_torch.ops import decode_step as tdsp
from voxtral_tpu_torch.parallel import make_mesh

BF16 = np.dtype(ml_dtypes.bfloat16)
SPEC_K = 4
JAX_LM_TILE = 512  # decode_step_pallas._lm_tile(1024, 256, 2)

requires_8_devices = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


# ---------------------------------------------------------------------------
# K1 (i) over the bf16 table
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    return build_inputs()


def _winners(rows: int):
    """Row m's planted winner (in JAX's second tile) and its twin (None,
    lower in the first tile, or above the winner), two rows of three
    with a twin."""
    win = [JAX_LM_TILE + 37 + 37 * m for m in range(rows)]
    twin = [None if m % 3 == 2 else (40 + 37 * m if m % 3 == 0
                                     else win[m] + 9) for m in range(rows)]
    return win, twin


def _planted_table(lm, x_out, final_norm, dev="cpu"):
    """The bf16 table with each row's winner planted (module docstring)
    -> (table [V, D] bf16 on ``dev``, the expected tokens)."""
    h = tdsp._rms(x_out.float().cpu(), to_torch(final_norm), EPS)
    table = to_torch(lm).clone()
    win, twin = _winners(h.shape[0])
    want = []
    for m in range(h.shape[0]):
        row = (h[m] * (3.0 / h[m].norm())).to(torch.bfloat16)
        table[win[m]] = row
        if twin[m] is not None:
            table[twin[m]] = row
        want.append(min(win[m], twin[m] if twin[m] is not None else V))
    return table.to(dev), want


def _step_args(inputs, offs, spec, dev="cpu"):
    params, t_embed, _, _, lm, final_norm = inputs
    x, cos, sin, kc, vc = _rows(inputs, offs, spec)
    tp = convert.params_from_numpy(params, dev)
    tf = tdsp.fuse_decode_weights_bf16(tp)

    def bf(a):
        return to_torch(np.asarray(a).astype(np.float32), dev).to(
            torch.bfloat16)

    args = (to_torch(x, dev), torch.tensor(offs, dtype=torch.int32,
                                           device=dev),
            tf["attn_norm"], tf["ffn_norm"],
            tdsp.ada_vectors(tp, to_torch(t_embed, dev)), None, None, None,
            None, to_torch(cos, dev), to_torch(sin, dev), bf(kc), bf(vc),
            tf["wqkv"], tf["wo"], tf["w13"], tf["w2"],
            to_torch(final_norm, dev))
    kw = dict(n_heads=N_HEADS, n_kv=N_KV, head_dim=HEAD_DIM, eps=EPS,
              window=4, spec=spec)
    return args, kw


@pytest.mark.parametrize("offs,spec", [([7], 1), ([5, 11], 3)],
                         ids=["1-row", "spec3-2-streams"])
def test_k1_lm_argmax_bf16_plain_matches_jax(inputs, offs, spec):
    params, t_embed, _, _, lm, final_norm = inputs
    args, kw = _step_args(inputs, offs, spec)
    x_out = tdsp.decode_stack_step_plain(*args, **kw)[0]
    table, want = _planted_table(lm, x_out, final_norm)
    got = tdsp.decode_stack_step(*args, table, lm_argmax=True, **kw)
    logits = tdsp.decode_stack_step(*args, table, **kw)[3]
    assert got[3].dtype == torch.int32 and got[3].shape == (len(want), 1)
    assert got[3][:, 0].tolist() == want == logits.argmax(-1).tolist()
    # Margin-robust: the next distinct logit trails by over 1e-2 of the
    # largest value.
    top = logits.max(-1, keepdim=True).values
    second = torch.where(logits == top, -np.inf, logits).max(-1).values
    assert ((top[:, 0] - second) > 1e-2 * logits.abs().max()).all()

    x, cos, sin, kc, vc = _rows(inputs, offs, spec)
    jtree = jax.tree_util.tree_map(jnp.asarray, params)
    jf = jdsp.fuse_decode_weights_bf16(jtree)
    ref = jdsp.decode_stack_step(
        jnp.asarray(x), jnp.asarray(offs, jnp.int32), jf["attn_norm"],
        jf["ffn_norm"], jdsp.ada_vectors(jtree, jnp.asarray(t_embed)),
        None, None, None, None, jnp.asarray(cos), jnp.asarray(sin),
        jnp.asarray(kc), jnp.asarray(vc), jf["wqkv"], jf["wo"], jf["w13"],
        jf["w2"], final_norm=jnp.asarray(final_norm),
        lm_codes=jnp.asarray(table.float().numpy()).astype(jnp.bfloat16),
        lm_scale=None, interpret=True, lm_argmax=True, **kw)
    assert np.asarray(ref[3])[:, 0].tolist() == want


# ---------------------------------------------------------------------------
# dp = 2 end to end
# ---------------------------------------------------------------------------


def _bf16_tree():
    tree = dense_params(tiny_config(), SEED, SCALE, FINAL_NORM_GAIN)
    return jax.tree_util.tree_map(lambda a: a.astype(BF16), tree)


@pytest.fixture(scope="module")
def models():
    """The port's bf16 models: one device, dp = 2 on CPUs."""
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, tree = tiny_config(), _bf16_tree()
    return {
        1: VoxtralModel.from_numpy(tree, cfg, "cpu"),
        2: VoxtralModel.from_numpy(tree, cfg,
                                   mesh=make_mesh(2, 1, ["cpu"] * 2)),
    }


def _mel2():
    mel = test_mel()
    return np.concatenate([mel, mel * 0.8])


def _solo(Session, model, sig, **kw):
    s = Session(model, step_positions=8, max_duration_s=20, **kw)
    for piece in np.array_split(sig, 3):
        s.feed(piece)
    s.finish()
    return s.tokens


# Four streams over two data groups; group 1 gets the two signals in the
# other order, so a stream routed to the wrong group's cache shows.
POOL_ORDER = (0, 1, 1, 0)


def _pool(Session, Pool, model, **kw):
    """A B = 4 pool of four streams fed in halves -> (pool, tokens)."""
    pool = Pool(model, max_streams=4, step_positions=8, max_duration_s=20,
                **kw)
    sessions = [Session(model, step_positions=8, pool=pool)
                for _ in POOL_ORDER]
    for half in range(2):
        for ses, i in zip(sessions, POOL_ORDER):
            ses.feed(np.array_split(SESSION_SIGNALS[i], 2)[half],
                     pump=False)
        pool.pump()
    for ses in sessions:
        ses.finish()
    return pool, [s.tokens for s in sessions]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's meshed bf16 model on the 8-device virtual mesh (its XLA
    step): the one-shot batch sequential and speculative, solo sessions
    on both signals, the B = 4 pool."""
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu.parallel import make_mesh as jax_make_mesh
    from voxtral_tpu.streaming import StreamingSession, StreamPool

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jm = JaxModel(jax.tree_util.tree_map(jnp.asarray, _bf16_tree()),
                  tiny_config(), mesh=jax_make_mesh(2, 1))
    return {
        "seq": np.asarray(jm.transcribe_streaming_batch(_mel2())),
        "spec": np.asarray(jm.transcribe_streaming_batch(
            _mel2(), speculative=SPEC_K)),
        "solo": [_solo(StreamingSession, jm, s) for s in SESSION_SIGNALS],
        "pool": _pool(StreamingSession, StreamPool, jm)[1],
    }


@requires_8_devices
def test_dp_oneshot_matches_jax_and_single_device(models, jax_runs):
    """Sequential and speculative ngram / pad at dp = 2: JAX's tokens,
    and the single device's batch exactly."""
    dp, one = models[2], models[1]
    dp.record_margins = True
    seq = dp.transcribe_streaming_batch(_mel2())
    dp.record_margins = False
    assert dp.last_decode_route == "dp"
    assert float(dp.last_margins.min()) > MIN_MARGIN
    assert len(set(seq[0].tolist())) > 1 and seq[0].tolist() != seq[1].tolist()
    assert seq.tolist() == jax_runs["seq"].tolist()
    assert seq.tolist() == one.transcribe_streaming_batch(_mel2()).tolist()
    for draft in ("ngram", "pad"):
        spec = dp.transcribe_streaming_batch(_mel2(), speculative=SPEC_K,
                                             draft=draft)
        assert 0 < dp.last_spec_passes
        assert spec.tolist() == seq.tolist()
    assert jax_runs["spec"].tolist() == seq.tolist()
    # One row pads to two and is trimmed, as JAX's _pad_dp_rows.
    assert dp.transcribe_streaming(test_mel()).tolist() == seq[0].tolist()


def test_dp_model_shares_the_stacks_and_counts_them_per_group(models):
    """On a shared device the data groups' stacks are the single-device
    stacks themselves (mode (g)'s segments as one tuple per group, the
    scale keys None, the dense table folded); ``check_hbm`` holds group 1
    to its own stacks' bytes."""
    from voxtral_tpu_torch.utils import hbm

    dp = models[2]
    st, fused = dp._dp_stacks, dp.fused_decode
    assert dp.decode_route == "bf16" and dp.fused_tp is None
    for name in ("sqkv", "so", "s13", "s2", "lm_scale"):
        assert st[name] is None
    for name in ("wqkv", "w13"):
        assert len(st[name]) == 2 and all(
            a is b for g in st[name] for a, b in zip(g, fused[name]))
    assert all(t is fused["wo"] for t in st["wo"])
    emb = dp.params["decoder"]["tok_embeddings"]
    assert st["lm_codes"][0] is st["lm_codes"][1] is emb
    own = sum(t.numel() * t.element_size() for t in hbm._leaves(
        [leaf[1] for leaf in st.values() if leaf is not None]))
    assert hbm.shard_weight_bytes(dp, 1, 0) == own
    assert hbm.shard_weight_bytes(dp, 0, 0) == hbm.model_hbm_bytes(dp)


def test_dp_oneshot_admission_counts_each_group(models, monkeypatch):
    """``oneshot_plan``'s mesh rung admits a bf16 batch at dp = 2 when
    each data group's device holds its stacks and its rows' head-major
    cache, the first device also the whole prefill cache; at one byte
    less it refuses (``HBMBudgetError``, naming shard (0, 0))."""
    from voxtral_tpu_torch.models import voxtral as tvx
    from voxtral_tpu_torch.utils import hbm

    dp = models[2]
    batch, seq_len = 4, 400
    copy = tvx.oneshot_cache_bytes(dp, batch // 2, seq_len)
    need = (hbm.shard_weight_bytes(dp, 0, 0) + copy + hbm.WORKSPACE_BYTES
            + tvx.oneshot_cache_bytes(dp, batch, seq_len))
    assert need > hbm.shard_weight_bytes(dp, 1, 0) + copy
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(need))
    assert tvx.oneshot_plan(dp, batch, seq_len)[0] == "dp"
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(need - 1))
    with pytest.raises(hbm.HBMBudgetError, match=r"mesh shard \(0, 0\)"):
        tvx.oneshot_plan(dp, batch, seq_len)


def _chunk_only(monkeypatch):
    """The port's pool ladder with its resident rungs refused: ``auto``
    lands on the chunked int8 rung, in chunks of 64 slots."""
    import voxtral_tpu_torch.streaming as tstreaming

    orig = tstreaming._fused_plan

    def plan(model, batch, cache_s, itemsize=None, chunk=None, **kw):
        if chunk is None:
            return None
        return orig(model, batch, cache_s, itemsize=itemsize, chunk=chunk,
                    **kw)

    monkeypatch.setattr(tstreaming, "_fused_plan", plan)
    monkeypatch.setattr(tstreaming, "CACHE_CHUNK", 64)


@requires_8_devices
@pytest.mark.parametrize("kv_dtype", ["model", "int8", "auto"],
                         ids=["bf16", "int8", "chunked"])
def test_dp_session_and_pool_match_jax(models, jax_runs, kv_dtype,
                                       monkeypatch):
    """A solo session on the dp = 2 model (data group 0) and a B = 4 dp
    = 2 pool on bf16 and on int8 caches, and on the chunked int8 rung
    (the resident rungs refused): JAX's meshed session and pool (its XLA
    step keeps bf16 caches), and the single device's pool exactly."""
    from voxtral_tpu_torch.streaming import StreamingSession, StreamPool

    if kv_dtype == "auto":
        _chunk_only(monkeypatch)
    dp = models[2]
    if kv_dtype == "model":
        dp.record_margins = True
        solo = []
        for sig in SESSION_SIGNALS:
            s = StreamingSession(dp, step_positions=8, max_duration_s=20)
            for piece in np.array_split(sig, 3):
                s.feed(piece)
            s.finish()
            assert min(s.margins) > MIN_MARGIN
            solo.append(s.tokens)
        dp.record_margins = False
        assert solo == jax_runs["solo"]
    pool, got = _pool(StreamingSession, StreamPool, dp, kv_dtype=kv_dtype)
    assert pool._dp_mesh is not None and pool._fused["dp"] == 2
    assert pool.cache_int8 == (kv_dtype != "model")
    assert pool._cache_chunk == (64 if kv_dtype == "auto" else None)
    assert got == jax_runs["pool"]
    assert got == _pool(StreamingSession, StreamPool, models[1],
                        kv_dtype=kv_dtype)[1]


def test_dp_operands_per_group_device():
    """``dp_decode_stack_step``'s operands: a list gives each data group
    its own entry; a replicated tensor or tuple of segments (mode (g)'s
    qkv and w13) moves to the group's device, segment by segment, so a
    group on a card of its own never launches on another card's
    pointers."""
    from voxtral_tpu_torch.parallel.dp_decode import _on

    segs = (torch.zeros(2, 3), torch.ones(4, 3))
    meta = torch.device("meta")
    moved = _on(segs, 1, meta)
    assert isinstance(moved, tuple) and all(t.device == meta for t in moved)
    assert [t.shape for t in moved] == [t.shape for t in segs]
    assert _on(segs, 0, torch.device("cpu"))[1] is segs[1]
    assert _on([segs, moved], 1, torch.device("cpu")) is moved
    assert _on(None, 1, meta) is None
    assert _on(segs[0], 1, meta).device == meta


def test_dp_pool_checkpoint_restores_on_one_device(models):
    """A slot of the dp = 2 pool (data group 1's) snapshots to the solo
    layout and restores into a single-device session, which continues as
    the restore of the same slot from a single-device pool does."""
    from voxtral_tpu_torch.streaming import StreamingSession, StreamPool

    sig, other = SESSION_SIGNALS

    def pooled_state(model):
        pool = StreamPool(model, max_streams=2, step_positions=8,
                          max_duration_s=20)
        pa = StreamingSession(model, step_positions=8, pool=pool)
        pb = StreamingSession(model, step_positions=8, pool=pool)
        pa.feed(other[:24000])
        pb.feed(sig[:40000])
        assert pb.positions_done > 0
        return pb.state_dict()

    def continued(state):
        s = StreamingSession.restore(models[1], state)
        s.feed(sig[40000:])
        s.finish()
        return s.tokens

    got = continued(pooled_state(models[2]))
    assert got == continued(pooled_state(models[1]))
    assert len(set(got)) > 1


def test_dense_meshes_that_remain_refused():
    """bf16 at tp > 1 and f32 on any mesh raise, naming ROADMAP item
    12.3b (JAX's GSPMD step, which the port does not have)."""
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg = tiny_config()
    tree = dense_params(cfg, SEED, SCALE, FINAL_NORM_GAIN)
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(BF16), tree)
    for t, (nd, nm) in ((bf16, (1, 2)), (bf16, (2, 2)), (tree, (2, 1)),
                        (tree, (1, 2))):
        with pytest.raises(ValueError, match="ROADMAP item 12.3b"):
            VoxtralModel.from_numpy(
                t, cfg, mesh=make_mesh(nd, nm, ["cpu"] * (nd * nm)))


def test_cli_model_dir_at_dp2(tmp_path, capsys):
    """``--model DIR --dp 2`` (default ``--dtype bfloat16``) prints the
    single device's text; ``--tp 2`` exits 2 naming item 12.3b."""
    from tests.test_torch_safetensors import write_model_dir
    from voxtral_tpu_torch import cli
    from voxtral_tpu_torch.audio import AudioBuffer, save_wav

    model_dir, _ = write_model_dir(tmp_path / "m", "bfloat16")
    wav = tmp_path / "tone.wav"
    mel_tone = np.sin(2 * np.pi * 440 * np.arange(24000) / 16000)
    save_wav(AudioBuffer((0.5 * mel_tone).astype(np.float32), 16000), wav)
    base = ["--model", str(model_dir), "--device", "cpu", "--audio",
            str(wav)]
    assert cli.main(base) == 0
    single = capsys.readouterr().out
    assert cli.main([*base, "--dp", "2"]) == 0
    assert capsys.readouterr().out == single
    # Two files decoded as one batch (transcribe_samples_batched) at dp = 2.
    assert cli.main([*base, "--audio", str(wav), "--dp", "2",
                     "--batch-files", "2"]) == 0
    assert capsys.readouterr().out == single * 2
    assert cli.main([*base, "--tp", "2"]) == 2
    assert "ROADMAP item 12.3b" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The vocabulary a tp mesh does not split (a repair)
# ---------------------------------------------------------------------------


def _w8_with_vocab(vocab: int):
    """The tiny w8 model with its vocabulary grown to ``vocab`` rows (the
    extra rows drawn at half the weight scale) -> (config, numpy tree)."""
    import dataclasses

    from voxtral_tpu_torch.utils.quantize import quantize_params_w8

    cfg = tiny_config()
    dense = dense_params(cfg, SEED, SCALE, FINAL_NORM_GAIN)
    emb = dense["decoder"]["tok_embeddings"]
    extra = np.random.default_rng(3).normal(
        size=(vocab - emb.shape[0], emb.shape[1])) * (SCALE / 2)
    dense["decoder"]["tok_embeddings"] = np.concatenate(
        [emb, extra.astype(emb.dtype)])
    cfg = dataclasses.replace(cfg, language_model=dataclasses.replace(
        cfg.language_model, vocab_size=vocab))
    return cfg, quantize_params_w8(dense)


@requires_8_devices
@pytest.mark.parametrize("vocab", [2562, 1281])
def test_tp_mesh_vocab_gate_matches_jax(vocab):
    """tp = 2 on the tiny w8 model with a grown vocabulary.  2562 rows:
    tp splits them but JAX's lm fold has no tile for 1281-row shards
    (``_lm_tile``), so JAX takes the greedy token from the whole lm_head
    (``models/voxtral.py:934``); the port folds it over the two shards
    (K6).  1281 rows: tp does not divide them; the port keeps the table
    whole and takes the whole lm_head on the first device (no K6), where
    JAX's meshed model refuses the tree (``shard_params`` cannot split
    the vocabulary), so the port is held to JAX's single device there.
    Tokens equal JAX's and the port's single device, every top-2 margin
    above ``MIN_MARGIN``."""
    from voxtral_tpu.models.voxtral import VoxtralModel as JaxModel
    from voxtral_tpu.parallel import make_mesh as jax_make_mesh
    from voxtral_tpu_torch.models.voxtral import VoxtralModel

    cfg, tree = _w8_with_vocab(vocab)
    mel2 = _mel2()
    tp = VoxtralModel.from_numpy(tree, cfg, mesh=make_mesh(1, 2, ["cpu"] * 2))
    assert ("lm_codes" in tp.fused_tp) == (vocab % 2 == 0)
    tp.record_margins = True
    got = tp.transcribe_streaming_batch(mel2)
    assert tp.last_decode_route == "tp"
    assert float(tp.last_margins.min()) > MIN_MARGIN
    one = VoxtralModel.from_numpy(tree, cfg, "cpu")
    assert got.tolist() == one.transcribe_streaming_batch(mel2).tolist()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOXTRAL_MEGAKERNEL", "force")
        if vocab % 2:
            with pytest.raises(ValueError, match="divisible by 2"):
                JaxModel(jtree, cfg, mesh=jax_make_mesh(1, 2))
            jm = JaxModel(jtree, cfg)
        else:
            jm = JaxModel(jtree, cfg, mesh=jax_make_mesh(1, 2))
            assert "lm_codes" not in jm.fused_tp
    assert got.tolist() == np.asarray(
        jm.transcribe_streaming_batch(mel2)).tolist()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("offs,spec", [([7], 1), ([2, 7, 9, 13], 2),
                                       ([5, 11, 3, 14], 3)],
                         ids=["1-row", "8-rows", "12-rows"])
def test_k1_lm_argmax_bf16_kernel_matches_plain_on_card(inputs, offs, spec):
    """K1 (i) over the planted bf16 table on the card: the token equals
    the plain version's and the argmax of mode (g)'s logits, bit for bit
    (12 rows: two table passes); the launch counters move."""
    dev = _card()
    lm, final_norm = inputs[4], inputs[5]
    args, kw = _step_args(inputs, offs, spec, dev)
    x_out = tdsp.decode_stack_step_plain(*args, **kw)[0]
    table, want = _planted_table(lm, x_out, final_norm, dev)
    before = (tdsp.decode_stack_step.argmax_launches,
              tdsp.decode_stack_step.argmax_bf16_launches)
    got = tdsp.decode_stack_step(*args, table, lm_argmax=True, **kw)
    logits = tdsp.decode_stack_step(*args, table, **kw)[3]
    ref = tdsp.decode_stack_step_plain(*args, table, lm_argmax=True, **kw)
    torch.cuda.synchronize()
    assert (tdsp.decode_stack_step.argmax_launches,
            tdsp.decode_stack_step.argmax_bf16_launches) == (
                before[0] + 1, before[1] + 1)
    assert got[3][:, 0].tolist() == ref[3][:, 0].tolist() == want
    assert got[3][:, 0].tolist() == logits.argmax(-1).tolist()
    for g, r in zip(got[:3], ref[:3]):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_dp_bf16_model_kernels_match_plain_on_card():
    """The dp = 2 bf16 model on one card: kernel tokens == plain tokens
    == the single card's, one-shot and in a B = 4 int8 pool; K1 (i)
    launches twice per position (one per data group)."""
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.streaming import StreamingSession, StreamPool

    dev = _card()
    cfg, tree = tiny_config(), _bf16_tree()
    mesh = make_mesh(2, 1, [dev] * 2)
    kern = VoxtralModel.from_numpy(tree, cfg, mesh=mesh)
    plain = VoxtralModel.from_numpy(tree, cfg, mesh=mesh, kernels=False)
    one = VoxtralModel.from_numpy(tree, cfg, dev)
    mel2 = _mel2()
    before = tdsp.decode_stack_step.argmax_bf16_launches
    got = kern.transcribe_streaming_batch(mel2)
    positions = got.shape[1] - 1
    launches = tdsp.decode_stack_step.argmax_bf16_launches - before
    assert launches == 2 * positions
    assert got.tolist() == plain.transcribe_streaming_batch(mel2).tolist()
    assert got.tolist() == one.transcribe_streaming_batch(mel2).tolist()
    pools = [_pool(StreamingSession, StreamPool, m, kv_dtype="int8")[1]
             for m in (kern, plain, one)]
    assert pools[0] == pools[1] == pools[2]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3072, 256])
def test_k1_bf16_fold_tokens_do_not_depend_on_the_row_count_on_card(k):
    """K1 (i)'s fold over a bf16 table on the card: the token of row i of
    an M-row call equals its 1-row call's for M in {1, 2, 8, 12, 64} (one
    table pass each), and the argmax of the GEMV's logits; ties planted
    across and within the fold's groups give the lower index."""
    dev = _card()
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.normal(size=(64, k)).astype(
        np.float32)).bfloat16().to(dev)
    table = torch.from_numpy((rng.normal(size=(4099, k)) * 0.02).astype(
        np.float32)).bfloat16().to(dev)
    first = tdsp.k1_linear(x[:2], table).argmax(-1).tolist()
    table[(first[0] + 33) % 4099] = table[first[0]]  # another group
    table[first[1] ^ 1] = table[first[1]]           # its own group
    ones = torch.cat([tdsp.k1_linear(x[i:i + 1], table, lm_argmax=True)
                      for i in range(64)])
    logits = tdsp.k1_linear(x, table)
    torch.cuda.synchronize()
    assert ones[:, 0].tolist() == logits.argmax(-1).tolist()
    assert ones[0, 0].item() == min(first[0], (first[0] + 33) % 4099)
    assert ones[1, 0].item() == min(first[1], first[1] ^ 1)
    for m in (1, 2, 8, 12, 64):
        got = tdsp.k1_linear(x[:m], table, lm_argmax=True)
        assert torch.equal(got, ones[:m]), m
