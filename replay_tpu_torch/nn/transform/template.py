"""Default per-split transform pipelines.

Counterpart of ``replay_tpu/nn/transform/template.py``: train = next-token shift
→ rename masks → unsqueeze → group; validate/test/predict = rename + group. The
packed SASRec pipelines add the segment-boundary fixup, the TwoTower ones the
in-batch negative pool, and the BERT4Rec ones mask tokens (masked-LM) instead
of shifting them.
"""

from __future__ import annotations

from typing import Dict, List

from replay_tpu_torch.data.nn.schema import TensorSchema

from .transforms import (
    CopyTransform,
    EqualityMaskTransform,
    GroupTransform,
    InBatchNegativeSamplingTransform,
    NextTokenTransform,
    RenameTransform,
    SegmentBoundaryMaskTransform,
    TokenMaskTransform,
    Transform,
    UnsqueezeTransform,
)


def make_default_sasrec_transforms(tensor_schema: TensorSchema) -> Dict[str, List[Transform]]:
    """Next-token-prediction pipelines keyed by split (train/validate/test/predict)."""
    item_id = tensor_schema.item_id_feature_name
    sequential = [f.name for f in tensor_schema.all_features if f.is_seq]
    train = [
        NextTokenTransform(label_name=item_id, shift=1, apply_to=sequential),
        RenameTransform({f"{item_id}_mask": "padding_mask", "positive_labels_mask": "target_padding_mask"}),
        UnsqueezeTransform("target_padding_mask", -1),
        UnsqueezeTransform("positive_labels", -1),
        GroupTransform({"feature_tensors": list(tensor_schema.names)}),
    ]
    eval_pipeline = [
        RenameTransform({f"{item_id}_mask": "padding_mask"}),
        GroupTransform({"feature_tensors": list(tensor_schema.names)}),
    ]
    return {
        "train": train,
        "validate": list(eval_pipeline),
        "test": list(eval_pipeline),
        "predict": list(eval_pipeline),
    }


def make_packed_sasrec_transforms(tensor_schema: TensorSchema) -> Dict[str, List[Transform]]:
    """Next-token pipelines for PACKED batches (PackedSequenceBatcher output).

    Identical to the SASRec template plus the packing fixups: labels that
    would cross a packed segment boundary are masked out of
    ``target_padding_mask``, and ``segment_ids`` is trimmed to the input
    length and left TOP-LEVEL in the batch (outside ``feature_tensors``) so
    the trainer's signature filtering hands it to the model's attention path.
    """
    item_id = tensor_schema.item_id_feature_name
    sequential = [f.name for f in tensor_schema.all_features if f.is_seq]
    train = [
        NextTokenTransform(label_name=item_id, shift=1, apply_to=sequential),
        RenameTransform({f"{item_id}_mask": "padding_mask", "positive_labels_mask": "target_padding_mask"}),
        # order matters: runs on the FULL-length segment ids (NextToken left
        # them untrimmed), masks boundary labels, then input-aligns them
        SegmentBoundaryMaskTransform(segment_name="segment_ids", mask_name="target_padding_mask", shift=1),
        UnsqueezeTransform("target_padding_mask", -1),
        UnsqueezeTransform("positive_labels", -1),
        GroupTransform({"feature_tensors": list(tensor_schema.names)}),
    ]
    eval_pipeline = [
        RenameTransform({f"{item_id}_mask": "padding_mask"}),
        GroupTransform({"feature_tensors": list(tensor_schema.names)}),
    ]
    return {
        "train": train,
        "validate": list(eval_pipeline),
        "test": list(eval_pipeline),
        "predict": list(eval_pipeline),
    }


def make_default_twotower_transforms(tensor_schema: TensorSchema) -> Dict[str, List[Transform]]:
    """SASRec's next-token pipelines + in-batch negatives for retrieval training
    (the in-batch pool replaces global uniform sampling)."""
    pipelines = make_default_sasrec_transforms(tensor_schema)
    pipelines["train"].append(InBatchNegativeSamplingTransform())
    return pipelines


def make_default_bert4rec_transforms(
    tensor_schema: TensorSchema, mask_prob: float = 0.15
) -> Dict[str, List[Transform]]:
    """Masked-LM pipelines: targets are the original items at masked positions
    (token_mask False = masked = predict here), the Bert4Rec training
    contract."""
    item_id = tensor_schema.item_id_feature_name
    train = [
        RenameTransform({f"{item_id}_mask": "padding_mask"}),
        TokenMaskTransform(token_name="padding_mask", mask_prob=mask_prob),
        CopyTransform({item_id: "positive_labels", "padding_mask": "target_padding_mask"}),
        # target positions = real tokens that were masked out
        EqualityMaskTransform(
            feature_name="token_mask",
            mask_name="target_padding_mask",
            equality_value=False,
            op="and",
        ),
        UnsqueezeTransform("positive_labels", -1),
        UnsqueezeTransform("target_padding_mask", -1),
        GroupTransform({"feature_tensors": list(tensor_schema.names)}),
    ]
    eval_pipeline = [
        RenameTransform({f"{item_id}_mask": "padding_mask"}),
        GroupTransform({"feature_tensors": list(tensor_schema.names)}),
    ]
    return {
        "train": train,
        "validate": list(eval_pipeline),
        "test": list(eval_pipeline),
        "predict": list(eval_pipeline),
    }
