"""Configuration system: frozen dataclasses + TOML loading.

A copy of ``styletts_zs_tpu/utils/config.py``: the port keeps its own copy so
that it imports nothing of the JAX package.  The dataclasses, defaults,
``tiny_test_config()`` and the TOML loader are the same, field for field, so
one TOML file configures both packages (``tests/test_torch_ops.py`` checks
that the two stay equal).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Tuple

try:  # python >= 3.11
    import tomllib as _toml
except ImportError:  # pragma: no cover
    _toml = None


@dataclass(frozen=True)
class AudioConfig:
    """Mel/STFT frontend parameters (SURVEY.md Appendix B: 24 kHz LibriTTS-style)."""

    sample_rate: int = 24000
    n_mels: int = 80
    n_fft: int = 2048
    win_length: int = 1200
    hop_length: int = 300
    fmin: float = 0.0
    fmax: float = 12000.0
    log_floor: float = 1e-5


@dataclass(frozen=True)
class TextEncoderConfig:
    """Phoneme text encoder: conv stack + transformer (TPU-first — no BiLSTM scan)."""

    vocab_size: int = 192  # phoneme-ID vocabulary incl. pad/bos/eos/punct
    dim: int = 512
    n_conv_layers: int = 3
    conv_kernel: int = 5
    n_attn_layers: int = 2
    n_heads: int = 8
    dropout: float = 0.1


@dataclass(frozen=True)
class ProsodyEncoderConfig:
    """Prosodic text encoder (replaces lineage's pretrained PL-BERT — offline build)."""

    dim: int = 512
    n_layers: int = 3
    n_heads: int = 8
    dropout: float = 0.1


@dataclass(frozen=True)
class StyleConfig:
    """Fixed-length time-varying discrete style codes (README.md:5 'A3')."""

    n_codes: int = 50          # K: number of time-varying style vectors
    d_style: int = 128         # style vector dim
    fsq_levels: Tuple[int, ...] = (8, 8, 8, 5, 5, 5)  # FSQ lattice per code
    extractor_dim: int = 512
    extractor_layers: int = 4
    n_heads: int = 8


@dataclass(frozen=True)
class PromptEncoderConfig:
    """Zero-shot reference-speaker (3 s enrolled audio) encoder (BASELINE.json:8)."""

    dim: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_prompt_tokens: int = 16  # pooled prompt tokens handed to the diffusion net


@dataclass(frozen=True)
class PredictorConfig:
    """Duration + F0/energy predictors (BASELINE.json:5)."""

    dim: int = 512
    n_layers: int = 3
    conv_kernel: int = 3
    dropout: float = 0.1
    max_duration: int = 50     # clamp for predicted per-phoneme frames


@dataclass(frozen=True)
class DecoderConfig:
    """Adversarially-trained mel decoder: AdaIN residual conv + windowed attention."""

    dim: int = 512
    n_blocks: int = 6
    conv_kernel: int = 5
    attn_every: int = 2        # attention block every N conv blocks
    n_heads: int = 8
    attn_window: int = 256     # frames each side; chunked attention (BASELINE.json:10)


@dataclass(frozen=True)
class DiffusionConfig:
    """Style latent diffusion (README.md:5 'A5/A6'): transformer denoiser, EDM-style."""

    dim: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_steps: int = 16          # undistilled sampler steps
    cfg_scale: float = 3.0
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0           # Karras schedule exponent
    cond_dropout: float = 0.1  # CFG training dropout of speaker prompt


@dataclass(frozen=True)
class VocoderConfig:
    """Transposed-conv upsampling + iSTFT head (BASELINE.json:5).

    total upsample = prod(upsample_rates) * istft_hop must equal audio hop (300).
    """

    upsample_rates: Tuple[int, ...] = (5, 5)
    upsample_kernels: Tuple[int, ...] = (10, 10)
    dims: Tuple[int, ...] = (512, 256, 128)  # len = len(rates)+1
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[int, ...] = (1, 3, 5)
    # Vocos-style heavier iSTFT head: stopping transposed-conv upsampling at
    # 25x (2 kHz frame rate) and letting the n_fft-48 overlap-add do the final
    # 12x keeps conv channels >= 128 (full lane tiles) and cuts the
    # sample-rate conv stage — ~1.5x faster vocoder at equal capacity
    istft_n_fft: int = 48
    istft_hop: int = 12


@dataclass(frozen=True)
class DiscriminatorConfig:
    """Multi-modal discriminators (README.md:5 'A4'): MPD + MRD + mel-patch."""

    mpd_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    mrd_ffts: Tuple[int, ...] = (512, 1024, 2048)
    mrd_hops: Tuple[int, ...] = (128, 256, 512)
    channels: int = 32
    max_channels: int = 256


@dataclass(frozen=True)
class ModelConfig:
    audio: AudioConfig = field(default_factory=AudioConfig)
    text_encoder: TextEncoderConfig = field(default_factory=TextEncoderConfig)
    prosody_encoder: ProsodyEncoderConfig = field(default_factory=ProsodyEncoderConfig)
    style: StyleConfig = field(default_factory=StyleConfig)
    prompt_encoder: PromptEncoderConfig = field(default_factory=PromptEncoderConfig)
    predictor: PredictorConfig = field(default_factory=PredictorConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    vocoder: VocoderConfig = field(default_factory=VocoderConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    max_text_len: int = 512    # static phoneme-sequence bound
    max_frames: int = 1024     # static mel-frame bound (default bucket)


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution knobs: precision, Pallas dispatch, mesh shape."""

    compute_dtype: str = "bfloat16"  # "float32" for the CPU golden path
    param_dtype: str = "float32"
    # The style-diffusion net runs fp32 regardless of compute_dtype (r5):
    # its (B, K=50, 128) latents are dispatch/HBM-bound, not MXU-bound
    # (stage-2 MFU 30%, ~1 ms of the 69 ms serving call), so bf16 buys
    # nothing — and the sampled latent feeds the DISCRETE lattice
    # projection, where bf16-vs-fp32 differences flip codes at lattice
    # boundaries and dominated the bench mel-MAE gate (0.17 vs the 0.066
    # decoder-only bf16 drift).  fp32 keeps the snap variant-stable.
    diffusion_dtype: str = "float32"
    use_pallas: bool = True          # False → XLA twins (CPU golden; BASELINE.json:7)
    mesh_data: int = 1               # data-parallel axis size
    mesh_model: int = 1              # tensor-parallel axis size (1 = replicated)
    donate_params: bool = True


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    lr: float = 1e-4
    lr_disc: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    weight_decay: float = 1e-2
    ema_decay: float = 0.999
    grad_clip: float = 1.0
    n_steps: int = 100000
    warmup_steps: int = 1000
    seed: int = 0
    checkpoint_every: int = 1000
    keep_checkpoints: int = 5
    log_every: int = 50
    # loss weights (stage 1)
    w_mel: float = 10.0
    w_adv: float = 1.0
    w_fm: float = 2.0
    w_dur: float = 1.0
    w_f0: float = 0.5
    w_energy: float = 0.5
    w_commit: float = 0.25   # reserved: FSQ needs no commitment loss
    w_align: float = 1.0     # forward-sum aligner objective (0 disables)
    # speaker-contrastive prompt-embedding loss (stage 1).  Without it the
    # prompt encoder receives NO gradient anywhere in the 3-stage pipeline
    # (stage 1's reconstruction path never calls encode_prompt; stages 2-3
    # freeze the acoustic params) and stays at random init — the root cause
    # of r3's collapsed speaker embedding (all pairwise cosines ~0.99,
    # sim_margin -0.024, retrieval at chance; VERDICT r3 missing items 1/3).
    # In-batch InfoNCE over (utterance mel, same-speaker reference mel)
    # pairs: synthetic speaker identity is free supervision.
    w_spk: float = 1.0
    spk_tau: float = 0.1     # InfoNCE temperature
    # Speaker CYCLE-consistency (r4 diagnosis, docs/artifacts/
    # prompt_influence_r4.json): with w_spk alone the embedding is perfect
    # on REAL audio (retrieval 1.0) yet reads synthesized mels as
    # out-of-distribution — even the teacher-forced (ground-truth-style)
    # decode retrieved 0/16 speakers.  These weights add the RECONSTRUCTED
    # mel and the VOCODED waveform's mel as extra positive views of the
    # same speaker in the InfoNCE, with gradients flowing through the
    # decoder/vocoder: the embedding learns the synthesis distribution and
    # the synthesis path is explicitly trained to preserve the identity
    # cues the embedding uses (the exact pathway the zero-shot similarity
    # metric measures; obligations A1/A6 of the source paper).
    w_spk_rec: float = 1.0   # reconstructed-mel view (through decoder)
    w_spk_voc: float = 1.0   # vocoded-wav-mel view (through vocoder too)
    # FSQ codebook-usage entropy bonus (VERDICT r3 item 6: dead lattice dim)
    w_fsq_entropy: float = 0.25
    use_mas_durations: bool = False  # MAS durations replace dataset's
    # stage 3 distillation
    w_latent: float = 1.0
    w_perceptual: float = 1.0
    distill_samples: int = 10000  # README.md:5: "only 10k samples"


@dataclass(frozen=True)
class ServeConfig:
    """Inference/serving knobs (acceptance configs 2-5, BASELINE.json:8-11)."""

    batch_size: int = 8
    one_step: bool = True          # distilled path; False = multi-step
    n_steps: int = 16
    guidance: float = 3.0
    with_vocoder: bool = True
    frame_buckets: Tuple[int, ...] = (256, 512, 1024, 2048, 4864)
    max_global_batch: int = 4096   # pod-scale mixed-speaker batch


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    name: str = "styletts_zs_tpu"


def _from_dict(cls, data: dict[str, Any]):
    kwargs = {}
    fld = {f.name: f for f in fields(cls)}
    for key, val in data.items():
        if key not in fld:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        ftype = fld[key].type
        if isinstance(val, dict):
            sub_cls = _resolve_type(ftype)
            kwargs[key] = _from_dict(sub_cls, val)
        elif isinstance(val, list):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


_TYPE_REGISTRY = {
    cls.__name__: cls
    for cls in (
        AudioConfig, TextEncoderConfig, ProsodyEncoderConfig, StyleConfig,
        PromptEncoderConfig, PredictorConfig, DecoderConfig, DiffusionConfig,
        VocoderConfig, DiscriminatorConfig, ModelConfig, RuntimeConfig,
        TrainConfig, ServeConfig, Config,
    )
}


def _resolve_type(ftype):
    if isinstance(ftype, str):
        return _TYPE_REGISTRY[ftype]
    return ftype


def load_config(path: str) -> Config:
    """Load a TOML config file, overlaying on defaults."""
    if _toml is None:  # pragma: no cover
        raise RuntimeError("tomllib unavailable; need python >= 3.11")
    with open(path, "rb") as f:
        data = _toml.load(f)
    return _from_dict(Config, data)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def replace(cfg, **kwargs):
    return dataclasses.replace(cfg, **kwargs)


# Preset configs mirroring the five acceptance configs (BASELINE.json:6-12).
def cpu_ref_config() -> Config:
    """Config 1: CPU golden — fp32, no Pallas, batch 1, deterministic."""
    return Config(
        runtime=RuntimeConfig(compute_dtype="float32", use_pallas=False),
    )


def tiny_test_config() -> Config:
    """Small shapes for fast unit/integration tests (not an acceptance config)."""
    return Config(
        model=ModelConfig(
            audio=AudioConfig(n_fft=512, win_length=400, hop_length=100,
                              n_mels=40, fmax=8000.0),
            text_encoder=TextEncoderConfig(dim=64, n_conv_layers=2, n_attn_layers=1,
                                           n_heads=4),
            prosody_encoder=ProsodyEncoderConfig(dim=64, n_layers=1, n_heads=4),
            style=StyleConfig(n_codes=8, d_style=32, extractor_dim=64,
                              extractor_layers=1, n_heads=4,
                              fsq_levels=(8, 8, 5)),
            prompt_encoder=PromptEncoderConfig(dim=64, n_layers=1, n_heads=4,
                                               n_prompt_tokens=4),
            predictor=PredictorConfig(dim=64, n_layers=1),
            decoder=DecoderConfig(dim=64, n_blocks=2, attn_every=2, n_heads=4,
                                  attn_window=32),
            diffusion=DiffusionConfig(dim=64, n_layers=2, n_heads=4, n_steps=4),
            vocoder=VocoderConfig(upsample_rates=(5, 5), upsample_kernels=(10, 10),
                                  dims=(64, 32, 16), resblock_kernels=(3,),
                                  resblock_dilations=(1, 3), istft_n_fft=8,
                                  istft_hop=4),
            discriminator=DiscriminatorConfig(mpd_periods=(2, 3), mrd_ffts=(256,),
                                              mrd_hops=(64,), channels=8,
                                              max_channels=32),
            max_text_len=64,
            max_frames=128,
        ),
        runtime=RuntimeConfig(compute_dtype="float32", use_pallas=False),
        train=TrainConfig(batch_size=2, n_steps=10),
    )
