"""Model configuration for Voxtral Mini 4B Realtime.

Parses the nested ``params.json`` shipped with the HuggingFace model.
Behavioral contract follows the reference parser
(``voxtral-mini-realtime-rs/src/models/config.rs:41-116``): LLM config at the top
level, encoder under ``multimodal.whisper_model_args.encoder_args``, audio
specs under ``...encoder_args.audio_encoding_args``, downsample factor under
``multimodal.whisper_model_args.downsample_args.downsample_factor``, and the
ADA t-conditioning flags ``ada_rms_norm_t_cond`` / ``ada_rms_norm_t_cond_dim``
at top level.  Every field has the same default as the reference
(``config.rs:441-535``).

The port's own copy of ``voxtral_tpu/config.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional


@dataclasses.dataclass
class AudioEncoderConfig:
    """Causal Whisper-style audio encoder (~0.97B params, 32 layers)."""

    dim: int = 1280
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    head_dim: int = 64
    hidden_dim: int = 5120
    sliding_window: int = 750
    # Max mel frames before chunking (None = unlimited, rely on window only).
    max_source_positions: Optional[int] = 1500
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    use_biases: bool = True
    causal: bool = True
    ffn_type: str = "swiglu"
    norm_type: str = "rms_norm"

    @classmethod
    def from_json_value(cls, v: dict[str, Any]) -> "AudioEncoderConfig":
        d = cls()
        msp = v.get("max_source_positions")
        return cls(
            dim=int(v.get("dim", d.dim)),
            n_layers=int(v.get("n_layers", d.n_layers)),
            n_heads=int(v.get("n_heads", d.n_heads)),
            n_kv_heads=int(v.get("n_kv_heads", d.n_kv_heads)),
            head_dim=int(v.get("head_dim", d.head_dim)),
            hidden_dim=int(v.get("hidden_dim", d.hidden_dim)),
            sliding_window=int(v.get("sliding_window", d.sliding_window)),
            # Missing OR null both fall back to 1500 (config.rs:179-182).
            max_source_positions=int(msp) if msp is not None else 1500,
            rope_theta=float(v.get("rope_theta", d.rope_theta)),
            norm_eps=float(v.get("norm_eps", d.norm_eps)),
            use_biases=bool(v.get("use_biases", d.use_biases)),
            causal=bool(v.get("causal", d.causal)),
            ffn_type=str(v.get("ffn_type", d.ffn_type)),
            norm_type=str(v.get("norm_type", d.norm_type)),
        )

    def max_mel_frames(self) -> Optional[int]:
        return self.max_source_positions

    def max_encoder_positions(self) -> Optional[int]:
        if self.max_source_positions is None:
            return None
        return self.max_source_positions // 4

    def effective_max_positions(self) -> int:
        if self.max_source_positions is None:
            return self.sliding_window
        return min(self.max_source_positions // 4, self.sliding_window)


@dataclasses.dataclass
class LanguageModelConfig:
    """Ministral-3B-based LM decoder (~3.4B params, 26 layers, GQA 32Q/8KV)."""

    dim: int = 3072
    n_layers: int = 26
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    hidden_dim: int = 9216
    vocab_size: int = 131072
    sliding_window: int = 8192
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tied_embeddings: bool = True
    use_biases: bool = False
    causal: bool = True

    @classmethod
    def from_json_value(cls, v: dict[str, Any]) -> "LanguageModelConfig":
        d = cls()
        return cls(
            dim=int(v.get("dim", d.dim)),
            n_layers=int(v.get("n_layers", d.n_layers)),
            n_heads=int(v.get("n_heads", d.n_heads)),
            n_kv_heads=int(v.get("n_kv_heads", d.n_kv_heads)),
            head_dim=int(v.get("head_dim", d.head_dim)),
            hidden_dim=int(v.get("hidden_dim", d.hidden_dim)),
            vocab_size=int(v.get("vocab_size", d.vocab_size)),
            sliding_window=int(v.get("sliding_window", d.sliding_window)),
            rope_theta=float(v.get("rope_theta", d.rope_theta)),
            norm_eps=float(v.get("norm_eps", d.norm_eps)),
            tied_embeddings=bool(v.get("tied_embeddings", d.tied_embeddings)),
            use_biases=bool(v.get("use_biases", d.use_biases)),
            causal=bool(v.get("causal", d.causal)),
        )

    def gqa_groups(self) -> int:
        return self.n_heads // self.n_kv_heads


@dataclasses.dataclass
class AdapterConfig:
    """Audio-to-LLM adapter: Linear(in,hidden) -> GELU -> Linear(hidden,out).

    Actual weight shapes are projection.0 [3072, 5120] / projection.2
    [3072, 3072], i.e. the flow is Linear(5120->3072) -> GELU ->
    Linear(3072->3072).  ``input_dim`` = encoder dim x downsample factor.
    """

    input_dim: int = 5120
    hidden_dim: int = 5120
    output_dim: int = 3072


@dataclasses.dataclass
class AudioInputConfig:
    """Audio input specifications (mel frontend parameters)."""

    sampling_rate: int = 16000
    num_mel_bins: int = 128
    hop_length: int = 160
    window_size: int = 400
    global_log_mel_max: float = 1.5
    frame_rate: float = 12.5
    transcription_format: str = "streaming"

    @classmethod
    def from_json_value(cls, v: dict[str, Any]) -> "AudioInputConfig":
        d = cls()
        return cls(
            sampling_rate=int(v.get("sampling_rate", d.sampling_rate)),
            num_mel_bins=int(v.get("num_mel_bins", d.num_mel_bins)),
            hop_length=int(v.get("hop_length", d.hop_length)),
            window_size=int(v.get("window_size", d.window_size)),
            global_log_mel_max=float(
                v.get("global_log_mel_max", d.global_log_mel_max)
            ),
            frame_rate=float(v.get("frame_rate", d.frame_rate)),
            transcription_format=str(
                v.get("transcription_format", d.transcription_format)
            ),
        )

    def ms_per_token(self) -> float:
        """Milliseconds of audio per decoder token (80 ms for Voxtral)."""
        return 1000.0 / self.frame_rate

    def samples_per_token(self) -> int:
        return int(self.sampling_rate / self.frame_rate)

    def raw_frame_rate(self) -> float:
        """Mel frame rate before conv downsampling (100 Hz)."""
        return self.sampling_rate / self.hop_length

    def max_duration_secs(self, max_mel_frames: int) -> float:
        return max_mel_frames * self.hop_length / self.sampling_rate

    def max_samples(self, max_mel_frames: int) -> int:
        return max_mel_frames * self.hop_length

    def mel_frames_for_samples(self, num_samples: int) -> int:
        return -(-num_samples // self.hop_length)


@dataclasses.dataclass
class VoxtralConfig:
    """Top-level configuration combining all components."""

    audio_encoder: AudioEncoderConfig = dataclasses.field(
        default_factory=AudioEncoderConfig
    )
    language_model: LanguageModelConfig = dataclasses.field(
        default_factory=LanguageModelConfig
    )
    adapter: AdapterConfig = dataclasses.field(default_factory=AdapterConfig)
    audio: AudioInputConfig = dataclasses.field(default_factory=AudioInputConfig)
    # 0 = ADA t-conditioning disabled.
    ada_rms_norm_t_cond_dim: int = 0
    downsample_factor: int = 4

    @classmethod
    def from_json(cls, text: str) -> "VoxtralConfig":
        v = json.loads(text)

        language_model = LanguageModelConfig.from_json_value(v)

        encoder_args = (
            v.get("multimodal", {})
            .get("whisper_model_args", {})
            .get("encoder_args")
        )
        audio_encoder = (
            AudioEncoderConfig.from_json_value(encoder_args)
            if encoder_args is not None
            else AudioEncoderConfig()
        )

        audio_encoding_args = (
            encoder_args.get("audio_encoding_args")
            if encoder_args is not None
            else None
        )
        audio = (
            AudioInputConfig.from_json_value(audio_encoding_args)
            if audio_encoding_args is not None
            else AudioInputConfig()
        )

        downsample_factor = int(
            v.get("multimodal", {})
            .get("whisper_model_args", {})
            .get("downsample_args", {})
            .get("downsample_factor", 4)
        )

        adapter = AdapterConfig(
            input_dim=audio_encoder.dim * downsample_factor,
            hidden_dim=audio_encoder.dim * downsample_factor,
            output_dim=language_model.dim,
        )

        if v.get("ada_rms_norm_t_cond", False):
            ada_dim = int(v.get("ada_rms_norm_t_cond_dim", 32))
        else:
            ada_dim = 0

        return cls(
            audio_encoder=audio_encoder,
            language_model=language_model,
            adapter=adapter,
            audio=audio,
            ada_rms_norm_t_cond_dim=ada_dim,
            downsample_factor=downsample_factor,
        )

    @classmethod
    def from_file(cls, path: str | Path) -> "VoxtralConfig":
        return cls.from_json(Path(path).read_text())

    @classmethod
    def from_model_dir(cls, dirpath: str | Path) -> "VoxtralConfig":
        return cls.from_file(Path(dirpath) / "params.json")

    def to_params_json(self) -> str:
        """Serialize to the nested params.json schema ``from_json``
        parses (round-trip tested) — used to synthesize model dirs for
        the day-one validation dry run (scripts/validate_real.py) and
        as a forensic dump of the parsed architecture."""
        lm, enc, au = self.language_model, self.audio_encoder, self.audio
        v: dict[str, Any] = {
            "dim": lm.dim, "n_layers": lm.n_layers,
            "head_dim": lm.head_dim, "hidden_dim": lm.hidden_dim,
            "n_heads": lm.n_heads, "n_kv_heads": lm.n_kv_heads,
            "use_biases": lm.use_biases, "causal": lm.causal,
            "rope_theta": lm.rope_theta, "norm_eps": lm.norm_eps,
            "vocab_size": lm.vocab_size,
            "tied_embeddings": lm.tied_embeddings,
            "sliding_window": lm.sliding_window,
            "multimodal": {
                "whisper_model_args": {
                    "encoder_args": {
                        "audio_encoding_args": {
                            "sampling_rate": au.sampling_rate,
                            "frame_rate": au.frame_rate,
                            "num_mel_bins": au.num_mel_bins,
                            "hop_length": au.hop_length,
                            "window_size": au.window_size,
                            "global_log_mel_max": au.global_log_mel_max,
                            "transcription_format":
                                au.transcription_format,
                        },
                        "dim": enc.dim, "n_layers": enc.n_layers,
                        "head_dim": enc.head_dim,
                        "hidden_dim": enc.hidden_dim,
                        "n_heads": enc.n_heads,
                        "n_kv_heads": enc.n_kv_heads,
                        "use_biases": enc.use_biases,
                        "rope_theta": enc.rope_theta,
                        "causal": enc.causal, "norm_eps": enc.norm_eps,
                        "max_source_positions": enc.max_source_positions,
                        "ffn_type": enc.ffn_type,
                        "norm_type": enc.norm_type,
                        "sliding_window": enc.sliding_window,
                    },
                    "downsample_args": {
                        "downsample_factor": self.downsample_factor,
                    },
                },
            },
            "ada_rms_norm_t_cond": self.ada_rms_norm_t_cond_dim > 0,
            "ada_rms_norm_t_cond_dim": self.ada_rms_norm_t_cond_dim or 32,
        }
        return json.dumps(v, indent=2)

    @classmethod
    def voxtral(cls) -> "VoxtralConfig":
        """Defaults matching the published Voxtral Mini 4B Realtime model."""
        cfg = cls()
        cfg.ada_rms_norm_t_cond_dim = 32
        return cfg

    def has_ada_rms_norm(self) -> bool:
        return self.ada_rms_norm_t_cond_dim > 0
