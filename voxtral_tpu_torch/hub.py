"""Model download helper (port of ``voxtral_tpu/hub.py``; parity with the
reference's ``src/hub.rs``).

Downloads ``mistralai/Voxtral-Mini-4B-Realtime-2602`` (consolidated
SafeTensors + params.json + tekken.json) via ``huggingface_hub`` when
network access is available; otherwise raises with instructions.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

DEFAULT_REPO = "mistralai/Voxtral-Mini-4B-Realtime-2602"

FILES = ("consolidated.safetensors", "params.json", "tekken.json")


@dataclasses.dataclass
class ModelPaths:
    weights: Path
    params: Path
    tekken: Path

    @classmethod
    def from_dir(cls, model_dir: str | Path) -> "ModelPaths":
        d = Path(model_dir)
        paths = cls(
            weights=d / "consolidated.safetensors",
            params=d / "params.json",
            tekken=d / "tekken.json",
        )
        missing = [p for p in (paths.weights, paths.params, paths.tekken)
                   if not p.exists()]
        if missing:
            raise FileNotFoundError(
                f"Missing model files in {d}: {[p.name for p in missing]}. "
                f"Run voxtral_tpu_torch.hub.download('{d}') or place them manually."
            )
        return paths


def download(
    target_dir: str | Path, repo_id: str = DEFAULT_REPO, revision: str | None = None
) -> ModelPaths:
    """Download the model into ``target_dir`` (needs network access)."""
    target = Path(target_dir)
    target.mkdir(parents=True, exist_ok=True)
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub is not installed; download the model files "
            f"({', '.join(FILES)}) from https://huggingface.co/{repo_id} "
            f"manually into {target}"
        ) from e

    for name in FILES:
        hf_hub_download(
            repo_id=repo_id,
            filename=name,
            revision=revision,
            local_dir=target,
        )
    return ModelPaths.from_dir(target)
