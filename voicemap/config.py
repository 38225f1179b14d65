"""Configuration layer (L0).

Rebuild of the reference's ``config.py`` (reference:
``config.py :: PATH, LIBRISPEECH_SAMPLING_RATE`` — see SURVEY.md §1 L0) plus the
hard-coded constants blocks at the top of the reference experiment scripts
(``experiments/train_siamese_net.py`` / ``train_classifier.py`` — SURVEY.md §5
"Config / flag system"). Instead of editable constants we expose frozen
dataclasses with presets for every config in BASELINE.json.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Reference: config.py :: LIBRISPEECH_SAMPLING_RATE
LIBRISPEECH_SAMPLING_RATE = 16000

# Reference: config.py :: PATH (repo-root abspath). We keep it overridable so
# tests can point at synthetic corpora.
PATH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_PATH = os.environ.get("VOICEMAP_DATA", os.path.join(PATH, "data"))

# Reference: voicemap/utils.py :: whiten(batch, rms=0.038021) — the fixed
# target RMS amplitude (≈ LibriSpeech mean fragment RMS).
DEFAULT_WHITEN_RMS = 0.038021


@dataclass(frozen=True)
class DataConfig:
    """Dataset + on-device preprocessing parameters.

    Mirrors the reference's ``LibriSpeechDataset(subsets, seconds, downsampling,
    stochastic, pad)`` constructor args (reference:
    ``voicemap/librispeech.py :: LibriSpeechDataset.__init__``) plus the
    preprocessing knobs of ``voicemap/utils.py :: preprocess_instances``.
    """

    data_root: str = DATA_PATH
    subsets: Tuple[str, ...] = ("dev-clean",)
    # Validation subsets for n-shot eval (reference: dev-clean with
    # stochastic=False). None ⇒ evaluate on the training store.
    val_subsets: Optional[Tuple[str, ...]] = None
    seconds: float = 3.0
    sample_rate: int = LIBRISPEECH_SAMPLING_RATE
    downsampling: int = 4
    stochastic: bool = True
    pad: bool = False
    label: str = "speaker"  # or "sex"
    # Whitening: per-fragment zero-mean then rescale to this fixed RMS
    # (reference: voicemap/utils.py :: whiten). Set to None to disable.
    whiten_rms: Optional[float] = DEFAULT_WHITEN_RMS
    # Epsilon guarding the RMS division for all-zero fragments (the reference
    # would emit NaNs there; we make the knob explicit).
    whiten_eps: float = 1e-8
    use_cache: bool = True

    @property
    def fragment_length(self) -> int:
        """Raw samples per fragment (pre-downsampling)."""
        return int(self.seconds * self.sample_rate)

    @property
    def model_length(self) -> int:
        """Samples per fragment as seen by the model (post-downsampling)."""
        return self.fragment_length // self.downsampling


@dataclass(frozen=True)
class EncoderConfig:
    """1D-conv encoder topology.

    Reference: ``voicemap/models.py :: get_baseline_convolutional_encoder``
    (SURVEY.md §3.5): 4 × [Conv1D(f·mult, k, same, relu) → BatchNorm →
    SpatialDropout1D → MaxPool1D] → GlobalMaxPool1D → Dense(embedding_dim).
    """

    filters: int = 128
    embedding_dim: int = 64
    dropout: float = 0.05
    filter_multipliers: Tuple[int, ...] = (1, 2, 3, 4)
    kernel_sizes: Tuple[int, ...] = (32, 3, 3, 3)
    pool_sizes: Tuple[int, ...] = (4, 2, 2, 2)
    # Dilation per block; all-ones is the baseline encoder. BASELINE.json
    # config #3 (deeper dilated stack at 4 kHz) uses DILATED_ENCODER below.
    dilations: Tuple[int, ...] = (1, 1, 1, 1)
    # bfloat16 compute / float32 params by default (bf16 tensor-core
    # operands, f32 accumulation); tests force float32 for exact parity.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Keras BatchNormalization defaults (the reference relies on them).
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3


@dataclass(frozen=True)
class SiameseConfig:
    """Siamese verification head.

    Reference: ``voicemap/models.py :: build_siamese_net(encoder, input_shape,
    distance_metric)``. ``same_label`` pins the sign convention the survey
    flags as [MED]: same=0 / different=1 so that a smaller sigmoid output
    means "same speaker" (argmin-consistent with n-shot eval, SURVEY.md §2.1).
    """

    distance_metric: str = "uniform_euclidean"
    # uniform_euclidean | weighted_l1 | uniform_l1 | dot_product | cosine_distance
    same_label: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters.

    Reference: constants block of ``experiments/train_siamese_net.py``
    (SURVEY.md §2.1: batchsize=64, Adam(clipnorm=1.), evaluate_every=500,
    num_evaluation_tasks=500, n=1, k=5).
    """

    batch_size: int = 64
    learning_rate: float = 1e-3
    clipnorm: float = 1.0
    num_steps: int = 2000
    loss: str = "bce"  # bce | contrastive (siamese); always softmax-CE for classifier
    contrastive_margin: float = 1.0
    evaluate_every: int = 500
    num_eval_tasks: int = 500
    n_shot: int = 1
    k_way: int = 5
    seed: int = 0
    # ReduceLROnPlateau-equivalent (reference: Keras callback on val n-shot acc)
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    min_lr: float = 1e-5
    # Refuse (instead of warn) when n-shot eval would gate the best
    # checkpoint / plateau LR on the TRAINING store because no val_subsets
    # are configured. The reference's protocol is held-out dev-clean with
    # stochastic=False; gating on the training store silently overstates
    # accuracy.
    require_holdout_eval: bool = False
    # Checkpointing (reference: ModelCheckpoint best-by-val_{n}-shot_acc).
    # Saves at every evaluation point; best-model selection is gated on the
    # validation n-shot accuracy, like the reference.
    checkpoint_dir: Optional[str] = None
    log_path: Optional[str] = None  # JSONL metrics


@dataclass(frozen=True)
class MelConfig:
    """Log-mel spectrogram frontend (BASELINE.json config #4)."""

    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    n_mels: int = 64
    fmin: float = 0.0
    fmax: Optional[float] = None  # defaults to sr/2
    log_eps: float = 1e-6


@dataclass(frozen=True)
class ExperimentConfig:
    """One end-to-end experiment = data + model + training."""

    name: str = "classifier_baseline"
    mode: str = "classifier"  # classifier | siamese | melspec2d
    data: DataConfig = field(default_factory=DataConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    siamese: SiameseConfig = field(default_factory=SiameseConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mel: MelConfig = field(default_factory=MelConfig)

    def artifact_name(self) -> str:
        """Hyperparameters-in-artifact-name convention (SURVEY.md §5)."""
        e, d, t = self.encoder, self.data, self.train
        return (
            f"{self.mode}__filters_{e.filters}__embed_{e.embedding_dim}"
            f"__drop_{e.dropout}__seconds_{d.seconds}__down_{d.downsampling}"
            f"__batch_{t.batch_size}"
        )

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets — one per BASELINE.json :: configs[i]
# ---------------------------------------------------------------------------

def classifier_baseline(**overrides) -> ExperimentConfig:
    """configs[0]: 1D-conv speaker classifier, dev-clean, 3 s @ 16 kHz, batch 32.

    Validation is held-out (test-clean, stochastic=False) — the reference's
    protocol gates best-checkpoint + plateau LR on a held-out subset's n-shot
    accuracy (``experiments/train_siamese_net.py :: validation args``), never
    on the training store.
    """
    cfg = ExperimentConfig(
        name="classifier_baseline",
        mode="classifier",
        data=DataConfig(subsets=("dev-clean",), seconds=3.0, downsampling=4,
                        val_subsets=("test-clean",)),
        train=TrainConfig(batch_size=32),
    )
    return cfg.replace(**overrides)


def siamese_verification(**overrides) -> ExperimentConfig:
    """configs[1]: siamese 1D-conv verification net on train-clean-100."""
    cfg = ExperimentConfig(
        name="siamese_verification",
        mode="siamese",
        data=DataConfig(subsets=("train-clean-100",), seconds=3.0, downsampling=4,
                        val_subsets=("dev-clean",)),
        encoder=EncoderConfig(dropout=0.0),
        train=TrainConfig(batch_size=64, loss="bce"),
    )
    return cfg.replace(**overrides)


def dilated_4khz(**overrides) -> ExperimentConfig:
    """configs[2]: 4 kHz waveform, deeper dilated conv1d stack."""
    cfg = ExperimentConfig(
        name="dilated_4khz",
        mode="classifier",
        data=DataConfig(subsets=("dev-clean",), seconds=3.0, downsampling=4,
                        val_subsets=("test-clean",)),
        encoder=EncoderConfig(
            filters=128,
            filter_multipliers=(1, 1, 2, 2, 3, 3, 4, 4),
            kernel_sizes=(32, 3, 3, 3, 3, 3, 3, 3),
            pool_sizes=(4, 1, 2, 1, 2, 1, 2, 1),
            dilations=(1, 2, 1, 4, 1, 8, 1, 16),
        ),
    )
    return cfg.replace(**overrides)


def melspec_2d(**overrides) -> ExperimentConfig:
    """configs[3]: log-mel frontend + 2D-CNN embedder (librosa-default
    framing: hop 160 = 10 ms, win 400 = 25 ms, n_fft 512, 64 mels)."""
    cfg = ExperimentConfig(
        name="melspec_2d",
        mode="melspec2d",
        data=DataConfig(subsets=("dev-clean",), seconds=3.0, downsampling=1,
                        val_subsets=("test-clean",),
                        whiten_rms=DEFAULT_WHITEN_RMS),
        mel=MelConfig(),
    )
    return cfg.replace(**overrides)


PRESETS = {
    "classifier_baseline": classifier_baseline,
    "siamese_verification": siamese_verification,
    "dilated_4khz": dilated_4khz,
    "melspec_2d": melspec_2d,
}
