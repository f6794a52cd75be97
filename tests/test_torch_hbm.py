"""Device-memory admission (``utils/hbm.py``) against the JAX package's
rule: weights + caches + workspace against the budget, which
``VOXTRAL_HBM_BYTES`` overrides and which does not exist on the CPU."""

import pytest
import torch

from voxtral_tpu_torch.utils import hbm


def test_budget_is_the_card_or_the_override(monkeypatch):
    monkeypatch.delenv("VOXTRAL_HBM_BYTES", raising=False)
    assert hbm.device_hbm_budget("cpu") is None
    assert hbm.device_hbm_budget(None) is None
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(5 * 2**30))
    assert hbm.device_hbm_budget("cpu") == 5 * 2**30


def test_tree_bytes_count_each_storage_once():
    a = torch.zeros((4, 8), dtype=torch.float32)
    tree = {"x": a, "y": {"view": a[1:], "b": torch.zeros(3, dtype=torch.int8)}}
    assert hbm.tree_unique_bytes(tree, {"again": a}, None) == 4 * 8 * 4 + 3


def _model():
    from tests.test_torch_model import tiny_config
    from voxtral_tpu_torch.models.voxtral import VoxtralModel
    from voxtral_tpu_torch.utils.quantize import random_w8_params

    cfg = tiny_config()
    return VoxtralModel.from_numpy(random_w8_params(cfg), cfg, "cpu")


def test_check_hbm_raises_over_budget_and_is_silent_on_cpu(monkeypatch):
    from voxtral_tpu_torch.streaming import StreamingSession

    model = _model()
    weights = hbm.model_hbm_bytes(model)
    # The fused stacks are copies (torch.cat), so they count.
    assert weights > hbm.tree_unique_bytes(model.params)
    monkeypatch.delenv("VOXTRAL_HBM_BYTES", raising=False)
    hbm.check_hbm(model, 10**15, "anything")  # CPU: no budget
    StreamingSession(model, unbounded=True)
    budget = weights + hbm.WORKSPACE_BYTES + 1000
    monkeypatch.setenv("VOXTRAL_HBM_BYTES", str(budget))
    hbm.check_hbm(model, 1000, "fits")
    with pytest.raises(hbm.HBMBudgetError, match="reduce to <= 1 streams"):
        hbm.check_hbm(model, 2000, "two streams", rows=2)
    with pytest.raises(hbm.HBMBudgetError, match="StreamingSession"):
        StreamingSession(model, max_duration_s=30)


def test_admission_matches_jax(monkeypatch):
    """The same weights (numpy -> JAX arrays / tensors) count the same
    bytes, and both packages refuse at the same budget."""
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    from tests.test_torch_model import tiny_config
    from voxtral_tpu.utils import hbm as jhbm
    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.utils.quantize import random_w8_params

    tree = random_w8_params(tiny_config())
    jmodel = SimpleNamespace(params=jax.tree_util.tree_map(jnp.asarray, tree))
    model = SimpleNamespace(params=params_from_numpy(tree, "cpu"),
                            device=torch.device("cpu"))
    weights = hbm.model_hbm_bytes(model)
    assert weights == jhbm.model_hbm_bytes(jmodel)
    monkeypatch.setenv("VOXTRAL_HBM_BYTES",
                       str(weights + hbm.WORKSPACE_BYTES + 4096))
    for cache in (4096, 4097):
        raised = []
        for mod, m in ((hbm, model), (jhbm, jmodel)):
            try:
                mod.check_hbm(m, cache, "a session")
                raised.append(False)
            except mod.HBMBudgetError:
                raised.append(True)
        assert raised == [cache > 4096] * 2


def test_session_cache_bytes_match_the_formula():
    from voxtral_tpu_torch.streaming import StreamingSession

    model = _model()
    for kw in (dict(unbounded=True), dict(max_duration_s=12.0)):
        s = StreamingSession(model, **kw)
        got = sum(t.numel() * t.element_size() for t in (
            s.enc_cache.k, s.enc_cache.v, s.dec_cache.k, s.dec_cache.v))
        assert got == s.cache_bytes
        assert s.dec_cache.k.shape[2] == s._max_dec
