"""The port imports torch and never jax, imports nothing of the JAX
package, ships its CUDA sources, runs on the card unless asked for the
CPU, and fails loudly where it cannot build or launch a kernel."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "voxtral_tpu_torch"


def test_importing_the_port_leaves_jax_out():
    # A fresh interpreter: this test process already imported jax
    # (tests/conftest.py).  Importing every module of the port (the
    # server, the client, wer and profiling too) and
    # running a tiny transcribe (on one device and on a 2 x 2 mesh of
    # CPUs) and a tiny pool on the CPU loads neither
    # jax nor any module of the JAX package voxtral_tpu.
    code = ("import sys\n"
            "import numpy as np\n"
            "import voxtral_tpu_torch, voxtral_tpu_torch.cli\n"
            "import voxtral_tpu_torch.pipeline, voxtral_tpu_torch.models.voxtral\n"
            "import voxtral_tpu_torch.ops.w8_kernel, voxtral_tpu_torch.ops.decode_step\n"
            "import voxtral_tpu_torch.ops.q4_kernel, voxtral_tpu_torch.loaders.gguf_loader\n"
            "import voxtral_tpu_torch.loaders.safetensors_loader, voxtral_tpu_torch.hub\n"
            "import voxtral_tpu_torch.loaders.param_cache\n"
            "import voxtral_tpu_torch.serving, voxtral_tpu_torch.client\n"
            "import voxtral_tpu_torch.utils.wer, voxtral_tpu_torch.utils.profiling\n"
            "import voxtral_tpu_torch.parallel, voxtral_tpu_torch.ops.decode_tp\n"
            "from voxtral_tpu_torch import VoxtralConfig\n"
            "from voxtral_tpu_torch.models.voxtral import VoxtralModel\n"
            "from voxtral_tpu_torch.utils.quantize import random_w8_params\n"
            "cfg = VoxtralConfig.from_file('tests/fixtures/params_tiny.json')\n"
            "model = VoxtralModel.from_numpy(random_w8_params(cfg), cfg, 'cpu')\n"
            "toks = model.transcribe_streaming(np.zeros((1, 128, 640), np.float32))\n"
            "assert toks.shape == (2,), toks.shape\n"
            "from voxtral_tpu_torch.parallel import make_mesh\n"
            "tp = VoxtralModel.from_numpy(random_w8_params(cfg), cfg,\n"
            "                             mesh=make_mesh(2, 2, ['cpu'] * 4))\n"
            "assert tp.transcribe_streaming(\n"
            "    np.zeros((1, 128, 640), np.float32)).shape == (2,)\n"
            "from voxtral_tpu_torch import StreamPool, StreamingSession\n"
            "pool = StreamPool(model, max_streams=2, max_duration_s=10,\n"
            "                  kv_dtype='int8')\n"
            "ses = StreamingSession(model, pool=pool)\n"
            "ses.feed(np.zeros(16000 * 3, np.float32))\n"
            "ses.finish()\n"
            "assert len(ses.tokens) == ses.positions_done - 38 > 8\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'voxtral_tpu' or m.startswith('voxtral_tpu.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_only_the_reused_modules():
    """Nothing of jax and nothing of the JAX package voxtral_tpu, in the
    package and in chip_smoke.py: the port keeps its own copies."""
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "voxtral_tpu"), f"{path}: imports {mod}"


def test_entry_points_default_to_the_card(monkeypatch):
    """No device means cuda; without a card that raises, naming
    device="cpu" — there is no silent CPU fallback."""
    from voxtral_tpu_torch.convert import params_from_numpy
    from voxtral_tpu_torch.device import resolve_device, to_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_torch([1.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"a": [1.0]})
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def test_cuda_sources_are_shipped():
    names = {p.name for p in (PKG / "csrc").glob("*.cu*")}
    assert {"w8_matmul.cu", "decode_step.cu", "w8_common.cuh",
            "q4_matmul.cu"} <= names
    pyproject = (REPO / "pyproject.toml").read_text()
    assert '"voxtral_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh"]' in pyproject


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from voxtral_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()
    assert "-gencode" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


FAKE_NVCC = """#!{python}
import sys
from pathlib import Path
args = sys.argv[1:]
out = Path(args[args.index("-o") + 1])
with open(out.parent.parent / "calls.log", "a") as log:
    log.write(" ".join(args) + "\\n")
if any(a.endswith("bad.cu") for a in args):
    sys.exit("bad.cu: error: expected a ';'")
out.write_text("built")
"""


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc per source (-c), then one link; a refused source raises
    with the compiler's message."""
    from voxtral_tpu_torch.ops import _build

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "common.cuh"):
        (csrc / name).write_text(f"// {name}\n")
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)

    lib, seconds = _build.build()
    assert lib.parent == build_dir and lib.read_text() == "built"
    assert seconds > 0
    calls = (build_dir / "calls.log").read_text().splitlines()
    assert len(calls) == 3
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in calls[:2]) == [
        "a.cu", "b.cu"]
    assert all(" -c " in c and "sm_90a" in c for c in calls[:2])
    assert calls[2].startswith("-shared -o")
    assert _build.build() == (lib, 0.0)  # cached by the sources' hash
    # The objects lived in a temporary directory that is gone.
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        [lib.name, "calls.log"])

    (csrc / "bad.cu").write_text("int x\n")
    with pytest.raises(_build.KernelBuildError, match="expected a ';'"):
        _build.build()


def test_wrappers_raise_on_a_device_they_cannot_serve():
    from voxtral_tpu_torch.ops import w8_kernel as k2

    meta = torch.device("meta")
    xq = torch.zeros((1, 32), dtype=torch.int8, device=meta)
    codes = torch.zeros((8, 32), dtype=torch.int8, device=meta)
    with pytest.raises(RuntimeError, match="unsupported device"):
        k2.w8_matmul(xq, torch.ones((1, 1), device=meta), codes,
                     torch.ones(8, device=meta))
    from voxtral_tpu_torch.ops import decode_tp as tp

    x = torch.zeros((1, 32), device=meta)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tp.lm_half_argmax(x, torch.ones(32, device=meta),
                          torch.ones(8, device=meta), codes, eps=1e-5)
    with pytest.raises(RuntimeError, match="unsupported device"):
        tp.ffn_half_step(x, 0, x[0], x[0], x, x[0], codes[None], codes[None],
                         eps=1e-5)


def test_numpy_bf16_round_trip():
    import ml_dtypes
    import numpy as np

    from voxtral_tpu_torch.device import to_torch

    a = (np.arange(12, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16)
    t = to_torch(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
