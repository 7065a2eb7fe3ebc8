"""The port's batch transforms against the JAX package's.

* Deterministic transforms: the same numpy batch through the JAX transform
  and the port's, every output leaf equal bit for bit, with the same shape
  and dtype.
* Stochastic transforms: torch's generator cannot draw JAX's numbers, so each
  is held to its contract: ``TokenMaskTransform``'s padding rule, its two
  corner cases (which at ``mask_prob`` 0 and 1 no draw can change, so those
  are held bit for bit to JAX too) and its mask rate within five binomial
  standard deviations; the negative samplers' range, shape and exclusions;
  ``Compose``'s generators, one a transform, the same for the same seed.
* The templates give the JAX batches' keys, shapes and dtypes per split.
"""

import numpy as np
import pytest
import torch

import jax

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn import transform as jt
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn import transform as pt

NUM_ITEMS, BATCH, SEQ_LEN = 50, 6, 10


def raw_batch(seed=0, length=SEQ_LEN):
    """Left-padded item windows (padding id = cardinality), one row all
    padding, one full, with their masks, segment ids and a float feature."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, length + 1, BATCH)
    lengths[0], lengths[1] = length, 0
    mask = np.arange(length)[None, :] >= length - lengths[:, None]
    ids = np.where(mask, rng.integers(0, NUM_ITEMS, (BATCH, length)), NUM_ITEMS).astype(np.int32)
    segments = np.where(mask, 1 + (np.arange(length)[None, :] >= length // 2), 0).astype(np.int32)
    return {
        "item_id": ids,
        "item_id_mask": mask,
        "rating": rng.standard_normal((BATCH, length)).astype(np.float32),
        "segment_ids": segments,
        "user": np.arange(BATCH, dtype=np.int32),
    }


def assert_same(got, want):
    assert isinstance(got, dict) and isinstance(want, dict)
    assert list(got) == list(want)
    for name in want:
        if isinstance(want[name], dict):
            assert_same(got[name], want[name])
            continue
        assert isinstance(got[name], torch.Tensor), name
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


DETERMINISTIC = {
    "next_token": lambda m: m.NextTokenTransform("item_id", apply_to=["item_id", "rating"]),
    "next_token_shift2_ignore": lambda m: m.NextTokenTransform("item_id", shift=2, ignore=["segment_ids", "user"]),
    "next_token_no_mask": lambda m: m.NextTokenTransform("rating", apply_to="rating"),
    "in_batch": lambda m: m.InBatchNegativeSamplingTransform(label_name="item_id"),
    "roll_forward": lambda m: m.SequenceRollTransform("item_id", roll=2, padding_value=NUM_ITEMS),
    "roll_back": lambda m: m.SequenceRollTransform("item_id", roll=-3),
    "trim": lambda m: m.TrimTransform(4, ["item_id", "item_id_mask"]),
    "adaptive_trim": lambda m: m.AdaptiveTrimTransform(["item_id", "rating"], padding_mask_name="item_id_mask"),
    "equality_and": lambda m: m.EqualityMaskTransform("item_id", "item_id_mask", NUM_ITEMS, "and"),
    "equality_or": lambda m: m.EqualityMaskTransform("segment_ids", "item_id_mask", 2, "or"),
    "equality_xor": lambda m: m.EqualityMaskTransform("segment_ids", "item_id_mask", 1, "xor"),
    "copy": lambda m: m.CopyTransform({"item_id": "labels", "item_id_mask": "target"}),
    "rename": lambda m: m.RenameTransform({"item_id_mask": "padding_mask", "user": "query_id"}),
    "select": lambda m: m.SelectTransform(["rating", "item_id"]),
    "unsqueeze": lambda m: m.UnsqueezeTransform("item_id", -1),
    "unsqueeze_front": lambda m: m.UnsqueezeTransform("user", 0),
    "group": lambda m: m.GroupTransform({"feature_tensors": ["item_id", "rating", "missing"]}),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_transform_matches_jax_bitwise(name):
    batch = raw_batch(1)
    want = DETERMINISTIC[name](jt)(dict(batch))
    got = DETERMINISTIC[name](pt)(dict(batch))
    assert_same(got, want)
    # torch tensors in give the same as numpy arrays in
    assert_same(DETERMINISTIC[name](pt)({k: torch.as_tensor(v) for k, v in batch.items()}), want)


def test_adaptive_trim_keeps_a_full_batch_and_trims_a_short_one():
    batch = raw_batch(2)
    batch["item_id_mask"][:, :3] = False
    got = pt.AdaptiveTrimTransform("item_id", padding_mask_name="item_id_mask")(batch)
    assert got["item_id"].shape == (BATCH, SEQ_LEN - 3)
    full = raw_batch(3)
    assert pt.AdaptiveTrimTransform("item_id", padding_mask_name="item_id_mask")(full)["item_id"].shape == (BATCH, SEQ_LEN)
    with pytest.raises(KeyError, match="not found"):
        pt.AdaptiveTrimTransform("item_id")(full)


def test_segment_boundary_mask_matches_jax_bitwise():
    batch = raw_batch(4)
    chain = lambda m: m.Compose([  # noqa: E731
        m.NextTokenTransform("item_id", apply_to=["item_id"]),
        m.RenameTransform({"positive_labels_mask": "target_padding_mask"}),
        m.SegmentBoundaryMaskTransform(),
    ])
    want = chain(jt)(dict(batch))
    got = chain(pt)(dict(batch))
    assert_same(got, want)
    with pytest.raises(ValueError, match="already trimmed"):
        pt.SegmentBoundaryMaskTransform()({**got, "segment_ids": got["segment_ids"]})


def test_argument_errors_match_jax():
    for m in (jt, pt):
        with pytest.raises(ValueError, match="must be <"):
            m.UniformNegativeSamplingTransform(5, 5)
        with pytest.raises(ValueError, match="non-zero"):
            m.SequenceRollTransform("item_id", roll=0)
        with pytest.raises(ValueError, match="op must be"):
            m.EqualityMaskTransform("a", "b", 1, op="nand")
        with pytest.raises(ValueError, match="empty classes"):
            m.MultiClassNegativeSamplingTransform(np.array([0, 2, 2]), 2)
        with pytest.raises(ValueError, match="Cannot trim"):
            m.TrimTransform(SEQ_LEN + 1, "item_id")(raw_batch())
        with pytest.raises(ValueError, match="boolean"):
            m.TokenMaskTransform("item_id")(raw_batch(), jax.random.PRNGKey(0) if m is jt else torch.Generator())


# --------------------------------------------------------------------------- #
# token mask
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("mask_prob", [0.0, 1.0])
def test_token_mask_corner_cases_match_jax_bitwise(mask_prob):
    """mask_prob 0 keeps every token, padding included (``uniform * padding
    >= 0``), so each row's last valid one gets masked; 1 masks every token, so
    each row with two or more keeps the one before its last: no draw changes
    either outcome."""
    batch = raw_batch(5)
    want = jt.TokenMaskTransform("item_id_mask", mask_prob=mask_prob)(dict(batch), jax.random.PRNGKey(0))
    got = pt.TokenMaskTransform("item_id_mask", mask_prob=mask_prob)(dict(batch), torch.Generator().manual_seed(0))
    assert_same(got, want)
    keep, padding = got["token_mask"].numpy(), batch["item_id_mask"]
    last = SEQ_LEN - 1 - np.argmax(padding[:, ::-1], axis=1)
    rows = np.arange(BATCH)
    real = padding.sum(axis=1)
    if mask_prob == 0.0:
        assert not keep[rows, last][real > 0].any()
        assert (keep.sum(axis=1) == SEQ_LEN - 1).all()
    else:
        assert keep[rows, last - 1][real > 1].all()
        assert (keep.sum(axis=1) == (real > 1)).all()


def test_token_mask_rate_and_padding_rule():
    rng = np.random.default_rng(6)
    rows, length, prob = 400, 50, 0.2
    lengths = rng.integers(2, length + 1, rows)
    padding = np.arange(length)[None, :] >= length - lengths[:, None]
    keep = pt.TokenMaskTransform("padding_mask", mask_prob=prob)(
        {"padding_mask": padding}, torch.Generator().manual_seed(1)
    )["token_mask"].numpy()
    assert keep.dtype == bool and keep.shape == padding.shape
    assert not keep[~padding].any()  # padded positions are never visible
    masked = (~keep & padding).sum(axis=1)
    assert (masked >= 1).all() and (masked < lengths).all()  # both corner cases repaired
    real = padding.sum()
    rate = masked.sum() / real
    # draws are Bernoulli(prob) per real token; the corner repairs move at most
    # one token a row, which the allowance covers
    sigma = np.sqrt(prob * (1 - prob) / real)
    assert abs(rate - prob) < 5 * sigma + rows / real, rate


def test_compose_draws_a_generator_for_each_stochastic_transform():
    batch = {"padding_mask": np.ones((BATCH, SEQ_LEN), bool), "item_id": raw_batch(7)["item_id"]}
    chain = pt.Compose([
        pt.TokenMaskTransform("padding_mask", mask_prob=0.5),
        pt.TokenMaskTransform("padding_mask", out_feature_name="second", mask_prob=0.5),
        pt.UniformNegativeSamplingTransform(NUM_ITEMS, 7),
    ])
    assert chain.needs_rng
    one = chain(dict(batch), torch.Generator().manual_seed(3))
    two = chain(dict(batch), torch.Generator().manual_seed(3))
    other = chain(dict(batch), torch.Generator().manual_seed(4))
    assert_same(one, {k: v.numpy() for k, v in two.items()})
    assert not torch.equal(one["token_mask"], one["second"])  # each transform its own draws
    assert not torch.equal(one["token_mask"], other["token_mask"])
    with pytest.raises(ValueError, match="needs an rng key"):
        chain(dict(batch))


# --------------------------------------------------------------------------- #
# negative samplers
# --------------------------------------------------------------------------- #
def test_uniform_negatives_range_shape_and_no_repeats():
    sampler = pt.UniformNegativeSamplingTransform(NUM_ITEMS, 20)
    for seed in range(5):
        out = sampler(raw_batch(), torch.Generator().manual_seed(seed))["negative_labels"]
        assert out.shape == (20,) and out.dtype == torch.int32
        assert ((out >= 0) & (out < NUM_ITEMS)).all()
        assert len(torch.unique(out)) == 20


def test_uniform_negatives_follow_the_distribution():
    weights = np.zeros(NUM_ITEMS, np.float32)
    weights[10:20] = 1.0
    weights[10] = 5.0
    sampler = pt.UniformNegativeSamplingTransform(NUM_ITEMS, 4, sample_distribution=weights)
    seen = set()
    for seed in range(20):
        out = sampler({}, torch.Generator().manual_seed(seed))["negative_labels"].numpy()
        assert len(set(out)) == 4 and ((out >= 10) & (out < 20)).all()  # zero-probability items never drawn
        seen.update(out.tolist())
    assert 10 in seen
    with pytest.raises(ValueError, match="must match cardinality"):
        pt.UniformNegativeSamplingTransform(NUM_ITEMS, 4, sample_distribution=weights[:-1])


def test_multi_class_negatives_stay_in_the_reference_class():
    classes = np.arange(NUM_ITEMS) % 4
    batch = raw_batch(8)
    batch["item_id"] = np.where(batch["item_id"] == NUM_ITEMS, 0, batch["item_id"])
    out = pt.MultiClassNegativeSamplingTransform(classes, 9)(batch, torch.Generator().manual_seed(0))
    negatives = out["negative_labels"].numpy()
    assert negatives.shape == (BATCH, 9)
    assert ((negatives >= 0) & (negatives < NUM_ITEMS)).all()
    row_class = classes[batch["item_id"][:, -1]]
    np.testing.assert_array_equal(classes[negatives], np.repeat(row_class[:, None], 9, axis=1))
    # a 1-D reference (one item per row) works as in JAX
    flat = pt.MultiClassNegativeSamplingTransform(classes, 3)({"item_id": batch["item_id"][:, -1]}, torch.Generator())
    assert flat["negative_labels"].shape == (BATCH, 3)


# --------------------------------------------------------------------------- #
# templates
# --------------------------------------------------------------------------- #
def schemas():
    jax_schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=8,
        )
    )
    port_schema = PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True, feature_hint=PortFeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=8,
        )
    )
    return jax_schema, port_schema


def layout(batch):
    return {
        name: layout(value) if isinstance(value, dict) else (tuple(value.shape), np.dtype(str(np.asarray(value).dtype)))
        for name, value in batch.items()
    }


@pytest.mark.parametrize("template", ["sasrec", "packed_sasrec", "twotower", "bert4rec"])
@pytest.mark.parametrize("split", ["train", "validate", "predict"])
def test_template_batches_match_jax_layout(template, split):
    jax_schema, port_schema = schemas()
    make = {
        "sasrec": "make_default_sasrec_transforms",
        "packed_sasrec": "make_packed_sasrec_transforms",
        "twotower": "make_default_twotower_transforms",
        "bert4rec": "make_default_bert4rec_transforms",
    }[template]
    batch = {k: v for k, v in raw_batch(9).items() if k in ("item_id", "item_id_mask", "segment_ids")}
    if template != "packed_sasrec":
        batch.pop("segment_ids")
    want = jt.Compose(getattr(jt, make)(jax_schema)[split])(dict(batch), jax.random.PRNGKey(0))
    got = pt.Compose(getattr(pt, make)(port_schema)[split])(dict(batch), torch.Generator().manual_seed(0))
    assert layout({k: v.numpy() if isinstance(v, torch.Tensor) else {kk: vv.numpy() for kk, vv in v.items()} for k, v in got.items()}) == layout(want)
    if template != "bert4rec" or split != "train":
        assert_same(got, want)  # nothing drawn: the same values too
    else:
        target = got["target_padding_mask"][..., 0].numpy()
        np.testing.assert_array_equal(target, got["padding_mask"].numpy() & ~got["token_mask"].numpy())
        np.testing.assert_array_equal(got["positive_labels"][..., 0].numpy(), batch["item_id"])
