"""Preprocessing (counterpart of ``replay_tpu/preprocessing``): so far the
label encoders that the sequence tokenizer fits. The filters, the
discretizer and the other transforms come with ROADMAP.md queue 1, item 11."""

from .label_encoder import (
    HandleUnknownStrategies,
    LabelEncoder,
    LabelEncoderPartialFitWarning,
    LabelEncoderTransformWarning,
    LabelEncodingRule,
    SequenceEncodingRule,
)

__all__ = [
    "HandleUnknownStrategies",
    "LabelEncoder",
    "LabelEncoderPartialFitWarning",
    "LabelEncoderTransformWarning",
    "LabelEncodingRule",
    "SequenceEncodingRule",
]
