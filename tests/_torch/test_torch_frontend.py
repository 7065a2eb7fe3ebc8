"""The port's data front end against the JAX package's, on the CPU.

The JAX front end runs on pandas; the port's on numpy columns, taking a frame
by duck type. The same inputs, made from a seed with numpy, go through both:

* (a) ``LabelEncodingRule``, ``SequenceEncodingRule`` and ``LabelEncoder``:
  codes in first-appearance order for int and string ids whose first
  appearance is out of sorted order, the inverse mappings, each
  ``handle_unknown`` strategy, ``partial_fit`` and the JSON artefacts (one
  package's ``save`` read by the other's ``load``).
* (b) ``LastNSplitter``: both splits, with equal timestamps within a user
  and cold users and items to drop; ``"timedelta"`` on numeric timestamps;
  sessions straddling the boundary moved to test or to train; ``save`` and
  ``load`` across the packages.
* (c) ``Dataset``'s counts and completed schema; ``SequenceTokenizer``'s
  sequences, query order and assigned cardinalities, with item-side and
  query features.
* (d) notebook 09's front end (``examples/ml1m_parity.py:78-112``) from one
  pandas frame: every split and every ``SequentialDataset`` column equal,
  with the port reading the frame by duck type and as numpy columns.
* (e) the notebook pipeline through both packages' ``fit`` and test-split
  ``validate``: a few users and items, 2 epochs of 1 block, dropout 0, f32,
  the port's initial weights converted by ``convert.py``.

Tolerance: none for (a)–(d): ids, codes, rows and dtypes are equal bit for
bit (the front end has no arithmetic to round). (e): metrics within rtol
1e-4 (f32 training in another summation order, as ``test_torch_train.py``).
"""

import numpy as np
import pandas as pd
import pytest
import torch

from replay_tpu.data import Dataset as JaxDataset
from replay_tpu.data import FeatureHint as JaxFeatureHint
from replay_tpu.data import FeatureInfo as JaxFeatureInfo
from replay_tpu.data import FeatureSchema as JaxFeatureSchema
from replay_tpu.data import FeatureType as JaxFeatureType
from replay_tpu.data.nn import SequenceBatcher as JaxSequenceBatcher
from replay_tpu.data.nn import SequenceTokenizer as JaxSequenceTokenizer
from replay_tpu.data.nn import TensorFeatureInfo as JaxTensorFeatureInfo
from replay_tpu.data.nn import TensorFeatureSource as JaxTensorFeatureSource
from replay_tpu.data.nn import TensorSchema as JaxTensorSchema
from replay_tpu.data.nn import validation_batches as jax_validation_batches
from replay_tpu.data.schema import FeatureSource as JaxFeatureSource
from replay_tpu.nn import OptimizerFactory as JaxOptimizerFactory
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.nn.transform import Compose as JaxCompose
from replay_tpu.nn.transform.template import make_default_sasrec_transforms as jax_sasrec_transforms
from replay_tpu.preprocessing.label_encoder import LabelEncoder as JaxLabelEncoder
from replay_tpu.preprocessing.label_encoder import LabelEncodingRule as JaxLabelEncodingRule
from replay_tpu.preprocessing.label_encoder import SequenceEncodingRule as JaxSequenceEncodingRule
from replay_tpu.splitters import LastNSplitter as JaxLastNSplitter
from replay_tpu_torch.convert import torch_to_flax
from replay_tpu_torch.data import Dataset, FeatureHint, FeatureInfo, FeatureSchema, FeatureSource, FeatureType
from replay_tpu_torch.data.nn import (
    SequenceBatcher,
    SequenceTokenizer,
    TensorFeatureInfo,
    TensorFeatureSource,
    TensorSchema,
    validation_batches,
)
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
from replay_tpu_torch.nn.transform import Compose, make_default_sasrec_transforms
from replay_tpu_torch.preprocessing import LabelEncoder, LabelEncodingRule, SequenceEncodingRule
from replay_tpu_torch.splitters import LastNSplitter
from replay_tpu_torch.utils.types import ColumnTable

# the two packages' classes side by side, by role
JAX = dict(
    Dataset=JaxDataset, FeatureHint=JaxFeatureHint, FeatureInfo=JaxFeatureInfo, FeatureSchema=JaxFeatureSchema,
    FeatureType=JaxFeatureType, FeatureSource=JaxFeatureSource, SequenceTokenizer=JaxSequenceTokenizer,
    TensorFeatureInfo=JaxTensorFeatureInfo, TensorFeatureSource=JaxTensorFeatureSource, TensorSchema=JaxTensorSchema,
    LastNSplitter=JaxLastNSplitter,
)
PORT = dict(
    Dataset=Dataset, FeatureHint=FeatureHint, FeatureInfo=FeatureInfo, FeatureSchema=FeatureSchema,
    FeatureType=FeatureType, FeatureSource=FeatureSource, SequenceTokenizer=SequenceTokenizer,
    TensorFeatureInfo=TensorFeatureInfo, TensorFeatureSource=TensorFeatureSource, TensorSchema=TensorSchema,
    LastNSplitter=LastNSplitter,
)


def raw_ids(kind: str, count: int, rng) -> np.ndarray:
    """``count`` distinct raw ids, sparse and shuffled (first appearance out
    of sorted order): ints drawn from a wider range, or strings."""
    ints = rng.choice(np.arange(1, 10 * count + 1), count, replace=False).astype(np.int64)
    return ints if kind == "int" else np.array([f"id{v:05d}" for v in ints], dtype=object)


def assert_same_column(got, want, name=""):
    """A port column (numpy) equal to a JAX frame column, values and dtype."""
    want = want.to_numpy() if hasattr(want, "to_numpy") else np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, name
    if want.dtype == object or got.dtype == object:
        assert got.tolist() == want.tolist(), name
    else:
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


def assert_same_table(got: ColumnTable, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for column in want.columns:
        assert_same_column(got[column], want[column], column)


# --------------------------------------------------------------------------- #
# (a) encoders
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["int", "str"])
def test_label_encoding_rule_codes_follow_first_appearance(kind):
    rng = np.random.default_rng(0)
    ids = raw_ids(kind, 12, rng)
    column = ids[rng.integers(0, 12, 60)]
    assert list(dict.fromkeys(column.tolist())) != sorted(set(column.tolist()))  # not in sorted order
    frame = pd.DataFrame({"item_id": column, "other": np.arange(60)})
    want_rule, rule = JaxLabelEncodingRule("item_id"), LabelEncodingRule("item_id")
    want_rule.fit(frame)
    rule.fit(frame)
    assert rule.get_mapping() == want_rule.get_mapping()
    assert list(rule.get_mapping()) == list(want_rule.get_mapping())
    assert rule.get_inverse_mapping() == want_rule.get_inverse_mapping()
    assert_same_table(rule.transform(frame), want_rule.transform(frame))
    codes = pd.DataFrame({"item_id": rule.transform(frame)["item_id"]})
    assert_same_table(rule.inverse_transform(codes), want_rule.inverse_transform(codes))
    np.testing.assert_array_equal(rule.inverse_transform(codes)["item_id"], column)
    # a mapping of numpy columns gives what the frame gives
    assert_same_table(rule.transform({"item_id": column, "other": np.arange(60)}), want_rule.transform(frame))


UNKNOWN = {
    "error": dict(handle_unknown="error"),
    "drop": dict(handle_unknown="drop"),
    "default_int": dict(handle_unknown="use_default_value", default_value=-7),
    "default_last": dict(handle_unknown="use_default_value", default_value="last"),
    "default_none": dict(handle_unknown="use_default_value"),
}


@pytest.mark.parametrize("kind", ["int", "str"])
@pytest.mark.parametrize("strategy", sorted(UNKNOWN))
def test_label_encoder_handles_unknown_labels_as_jax(kind, strategy):
    rng = np.random.default_rng(1)
    ids = raw_ids(kind, 10, rng)
    fit = pd.DataFrame({"user_id": ids[rng.integers(0, 4, 20)], "item_id": ids[rng.integers(0, 6, 20)]})
    later = pd.DataFrame({"user_id": ids[rng.integers(0, 8, 30)], "item_id": ids[rng.integers(0, 10, 30)]})
    kwargs = UNKNOWN[strategy]
    want = JaxLabelEncoder([JaxLabelEncodingRule(c, **kwargs) for c in ("user_id", "item_id")]).fit(fit)
    got = LabelEncoder([LabelEncodingRule(c, **kwargs) for c in ("user_id", "item_id")]).fit(fit)
    assert got.mapping == want.mapping and got.inverse_mapping == want.inverse_mapping
    if strategy == "error":
        with pytest.raises(ValueError, match="unknown labels"):
            want.transform(later)
        with pytest.raises(ValueError, match="unknown labels"):
            got.transform(later)
        return
    expected = want.transform(later)
    assert len(expected) < len(later) if strategy == "drop" else len(expected) == len(later)
    assert_same_table(got.transform(later), expected)


@pytest.mark.parametrize("kind", ["int", "str"])
def test_partial_fit_and_artefacts_cross_packages(kind, tmp_path):
    rng = np.random.default_rng(2)
    ids = raw_ids(kind, 9, rng)
    first = pd.DataFrame({"item_id": ids[rng.integers(0, 5, 15)]})
    second = pd.DataFrame({"item_id": ids[rng.integers(0, 9, 15)]})
    want = JaxLabelEncoder([JaxLabelEncodingRule("item_id", handle_unknown="drop")]).fit(first).partial_fit(second)
    got = LabelEncoder([LabelEncodingRule("item_id", handle_unknown="drop")]).fit(first).partial_fit(second)
    assert list(got.mapping["item_id"].items()) == list(want.mapping["item_id"].items())
    got.save(str(tmp_path / "port"))
    want.save(str(tmp_path / "jax"))
    # each package reads the other's artefact into the same encoder
    assert JaxLabelEncoder.load(str(tmp_path / "port")).mapping == want.mapping
    assert LabelEncoder.load(str(tmp_path / "jax")).mapping == want.mapping
    assert_same_table(LabelEncoder.load(str(tmp_path / "jax")).transform(second), want.transform(second))
    with pytest.warns(Warning, match="partial_fit called before fit"):
        LabelEncodingRule("item_id").partial_fit(first)


@pytest.mark.parametrize("strategy", ["error", "drop", "default_int"])
def test_sequence_encoding_rule_matches_jax(strategy):
    rng = np.random.default_rng(3)
    ids = raw_ids("str", 8, rng)
    fit = pd.DataFrame({"items": [list(ids[rng.integers(0, 5, n)]) for n in (3, 1, 4, 2)]})
    later = pd.DataFrame({"items": [list(ids[rng.integers(0, 8, n)]) for n in (2, 5, 3)]})
    kwargs = UNKNOWN[strategy]
    want, got = JaxSequenceEncodingRule("items", **kwargs).fit(fit), SequenceEncodingRule("items", **kwargs).fit(fit)
    assert list(got.get_mapping().items()) == list(want.get_mapping().items())
    if strategy == "error":
        for rule in (want, got):
            with pytest.raises(ValueError, match="unknown label"):
                rule.transform(later)
        return
    expected = want.transform(later)["items"]
    encoded = got.transform(later)["items"]
    assert len(encoded) == len(expected)
    for row, want_row in zip(encoded, expected):
        assert row.dtype == want_row.dtype == np.int64
        np.testing.assert_array_equal(row, want_row)
    decoded = got.inverse_transform(pd.DataFrame({"items": list(encoded)}))["items"]
    for row, want_row in zip(decoded, want.inverse_transform(pd.DataFrame({"items": list(expected)}))["items"]):
        assert row.tolist() == want_row.tolist()


# --------------------------------------------------------------------------- #
# (b) LastNSplitter
# --------------------------------------------------------------------------- #
def tied_log(seed: int, users: int = 12, items: int = 15, events: int = 150) -> pd.DataFrame:
    """Raw sparse ids, few timestamps (many equal within a user), and a user
    and an item that appear once, late: cold after the split."""
    rng = np.random.default_rng(seed)
    user_ids, item_ids = raw_ids("int", users, rng), raw_ids("int", items, rng)
    frame = pd.DataFrame({
        "user_id": user_ids[rng.integers(0, users - 1, events)],
        "item_id": item_ids[rng.integers(0, items - 1, events)],
        "timestamp": rng.integers(0, 6, events),
        "session_id": rng.integers(0, 3, events),
    })
    cold = pd.DataFrame({
        "user_id": [user_ids[-1], user_ids[0]], "item_id": [item_ids[0], item_ids[-1]], "timestamp": [9, 99],
        "session_id": [0, 2],
    })
    return pd.concat([frame, cold], ignore_index=True)


SPLITS = {
    "last1": dict(N=1, strategy="interactions"),
    "last3": dict(N=3, strategy="interactions"),
    "last1_cold": dict(N=1, strategy="interactions", drop_cold_users=True, drop_cold_items=True),
    "timedelta2_cold": dict(N=2, strategy="timedelta", drop_cold_users=True, drop_cold_items=True),
    "last2_sessions_to_test": dict(N=2, strategy="interactions", session_id_column="session_id"),
    "last2_sessions_to_train": dict(
        N=2, strategy="interactions", session_id_column="session_id", session_id_processing_strategy="train"
    ),
}


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_last_n_splitter_matches_jax(case):
    frame = tied_log(4)
    kwargs = dict(divide_column="user_id", query_column="user_id", **SPLITS[case])
    want_train, want_test = JaxLastNSplitter(**kwargs).split(frame)
    got_train, got_test = LastNSplitter(**kwargs).split(frame)
    assert_same_table(got_train, want_train.reset_index(drop=True))
    assert_same_table(got_test, want_test.reset_index(drop=True))
    if "cold" in case:  # the cold user's and the cold item's rows left the test split
        assert len(want_test) < len(frame) - len(want_train)
    # twice, as the notebook splits: the second split of the first's train
    got_again = LastNSplitter(**kwargs).split(got_train)
    for got, want in zip(got_again, JaxLastNSplitter(**kwargs).split(want_train)):
        assert_same_table(got, want.reset_index(drop=True))


def test_splitter_artefacts_cross_packages(tmp_path):
    """Each package's ``Splitter.save`` loads in the other's ``load`` with the
    same init arguments."""
    kwargs = dict(N=2, divide_column="user_id", query_column="user_id", strategy="timedelta", drop_cold_items=True)
    LastNSplitter(**kwargs).save(str(tmp_path / "port"))
    JaxLastNSplitter(**kwargs).save(str(tmp_path / "jax"))
    from_port, from_jax = JaxLastNSplitter.load(str(tmp_path / "port")), LastNSplitter.load(str(tmp_path / "jax"))
    assert from_port._init_args == JaxLastNSplitter(**kwargs)._init_args == from_jax._init_args


def test_timedelta_reads_datetimes_and_iso_strings_as_seconds():
    """The port's parsing (the JAX package parses through ``pd.to_datetime``):
    datetime64 and ISO 8601 strings split as their seconds do; any other
    string format raises."""
    frame = tied_log(5)
    seconds = frame["timestamp"].to_numpy() * 60 + 1_600_000_000
    kwargs = dict(N=150, strategy="timedelta", divide_column="user_id", query_column="user_id")
    want = LastNSplitter(**kwargs).split({**frame.to_dict("series"), "timestamp": seconds})[1]
    stamps = seconds.astype("datetime64[s]")
    for timestamps in (stamps, np.array([str(t) for t in stamps], dtype=object)):
        got = LastNSplitter(**kwargs).split({**frame.to_dict("series"), "timestamp": timestamps})[1]
        np.testing.assert_array_equal(got["user_id"], want["user_id"])
        np.testing.assert_array_equal(got["item_id"], want["item_id"])
    with pytest.raises(ValueError, match="ISO 8601"):
        LastNSplitter(**kwargs).split({**frame.to_dict("series"), "timestamp": np.array(["01/02/2020"] * len(frame))})


# --------------------------------------------------------------------------- #
# (c) Dataset and SequenceTokenizer
# --------------------------------------------------------------------------- #
def features_log(kind: str, seed: int = 6):
    """Interactions with a rating, item features (a category, one per item)
    and query features (an age group), raw ids of ``kind``."""
    rng = np.random.default_rng(seed)
    users, items = raw_ids(kind, 9, rng), raw_ids(kind, 14, rng)
    interactions = pd.DataFrame({
        "user_id": users[rng.integers(0, 9, 90)],
        "item_id": items[rng.integers(0, 14, 90)],
        "timestamp": rng.integers(0, 8, 90),
        "rating": rng.integers(1, 6, 90).astype(np.float64),
    })
    item_features = pd.DataFrame({"item_id": items[rng.permutation(14)], "category": raw_ids("str", 14, rng)[rng.integers(0, 4, 14)]})
    query_features = pd.DataFrame({"user_id": users[::-1].copy(), "age": rng.integers(1, 5, 9)})
    return interactions, item_features, query_features


def feature_schema(m):
    return m["FeatureSchema"]([
        m["FeatureInfo"]("user_id", m["FeatureType"].CATEGORICAL, m["FeatureHint"].QUERY_ID),
        m["FeatureInfo"]("item_id", m["FeatureType"].CATEGORICAL, m["FeatureHint"].ITEM_ID),
        m["FeatureInfo"]("timestamp", m["FeatureType"].NUMERICAL, m["FeatureHint"].TIMESTAMP),
        m["FeatureInfo"]("category", m["FeatureType"].CATEGORICAL),
        m["FeatureInfo"]("age", m["FeatureType"].CATEGORICAL),
    ])


def tensor_schema(m):
    src = m["FeatureSource"]

    def seq(name, source, column, hint=None):
        return m["TensorFeatureInfo"](
            name, m["FeatureType"].CATEGORICAL, is_seq=True, feature_hint=hint,
            feature_sources=[m["TensorFeatureSource"](source, column)], embedding_dim=8,
        )

    return m["TensorSchema"]([
        seq("item_id", src.INTERACTIONS, "item_id", m["FeatureHint"].ITEM_ID),
        seq("category", src.ITEM_FEATURES, "category"),
        m["TensorFeatureInfo"]("age", m["FeatureType"].CATEGORICAL, is_seq=False,
                               feature_sources=[m["TensorFeatureSource"](src.QUERY_FEATURES, "age")], embedding_dim=4),
        m["TensorFeatureInfo"]("rating", m["FeatureType"].NUMERICAL, is_seq=True,
                               feature_sources=[m["TensorFeatureSource"](src.INTERACTIONS, "rating")], tensor_dim=1),
    ])


def assert_same_sequences(got, want):
    """Two SequentialDatasets: the same queries in the same order, each
    feature's rows equal in values and dtype."""
    assert len(got) == len(want)
    assert_same_column(got.query_ids, want.query_ids, "query ids")
    for name in want.schema:
        for index in range(len(want)):
            got_row, want_row = got.get_sequence(index, name), want.get_sequence(index, name)
            assert got_row.dtype == want_row.dtype, (name, got_row.dtype, want_row.dtype)
            np.testing.assert_array_equal(got_row, want_row, err_msg=name)


@pytest.mark.parametrize("kind", ["int", "str"])
def test_dataset_counts_and_completed_schema_match_jax(kind):
    interactions, item_features, query_features = features_log(kind)
    datasets = {}
    for label, m in (("jax", JAX), ("port", PORT)):
        with pytest.warns(UserWarning, match="'rating' is not described"):
            datasets[label] = m["Dataset"](
                feature_schema(m), interactions, query_features=query_features, item_features=item_features
            )
    want, got = datasets["jax"], datasets["port"]
    assert got.is_pandas and not got.is_categorical_encoded
    assert (got.query_count, got.item_count) == (want.query_count, want.item_count) == (9, 14)
    for feature in want.feature_schema.all_features:
        mine = got.feature_schema[feature.column]
        assert (mine.feature_type.value, mine.feature_source.value) == (feature.feature_type.value, feature.feature_source.value)
        if feature.feature_type.is_categorical:
            assert mine.cardinality == feature.cardinality, feature.column
    assert_same_column(got.query_ids["user_id"], want.query_ids["user_id"])
    assert_same_column(got.item_ids["item_id"], want.item_ids["item_id"])
    subset = got.subset(["timestamp"])
    assert subset.feature_schema.columns == want.subset(["timestamp"]).feature_schema.columns
    assert subset.item_features is None and subset.query_features is None
    with pytest.raises(ValueError, match="absent in the feature frame"):
        Dataset(feature_schema(PORT), interactions, item_features=item_features.iloc[1:])
    # ids declared encoded: strings are refused, and so are negative ints
    raw = interactions[["user_id", "item_id", "timestamp"]].copy()
    if kind == "int":
        raw["item_id"] = -raw["item_id"]
    for m in (JAX, PORT):
        with pytest.raises(ValueError, match="not integer-typed" if kind == "str" else "negative ids"):
            m["Dataset"](feature_schema(m).subset(raw.columns), raw, categorical_encoded=True)
    with pytest.raises(NotImplementedError, match="item 11"):
        got.save("unused")


@pytest.mark.parametrize("kind", ["int", "str"])
def test_sequence_tokenizer_matches_jax(kind, tmp_path):
    interactions, item_features, query_features = features_log(kind)
    half = interactions.iloc[45:]
    results = {}
    for label, m in (("jax", JAX), ("port", PORT)):
        schema = tensor_schema(m)
        tokenizer = m["SequenceTokenizer"](schema, handle_unknown_rule="drop")
        with pytest.warns(UserWarning, match="not described"):
            fit_on = m["Dataset"](feature_schema(m), interactions, query_features=query_features, item_features=item_features)
            later = m["Dataset"](feature_schema(m), half, query_features=query_features, item_features=item_features)
        results[label] = (tokenizer.fit_transform(fit_on), tokenizer.transform(later), schema, tokenizer)
    (want_fit, want_later, want_schema, want_tokenizer), (got_fit, got_later, got_schema, tokenizer) = results.values()
    assert_same_sequences(got_fit, want_fit)
    assert_same_sequences(got_later, want_later)
    for name in ("item_id", "category", "age"):
        assert got_schema[name].cardinality == want_schema[name].cardinality, name
    assert list(got_fit.query_ids) == sorted(got_fit.query_ids)  # groups in ascending query order
    # the JAX artefact loads into the port's tokenizer and transforms alike
    want_tokenizer.save(str(tmp_path / "jax"))
    loaded = SequenceTokenizer.load(str(tmp_path / "jax"))
    with pytest.warns(UserWarning, match="not described"):
        again = loaded.transform(Dataset(feature_schema(PORT), half, query_features=query_features, item_features=item_features))
    assert_same_sequences(again, want_later)
    tokenizer.save(str(tmp_path / "port"))
    assert JaxSequenceTokenizer.load(str(tmp_path / "port")).item_id_encoder.mapping == want_tokenizer.item_id_encoder.mapping


# --------------------------------------------------------------------------- #
# (d) notebook 09's front end, and (e) its pipeline
# --------------------------------------------------------------------------- #
def notebook_frame(seed: int = 7, users: int = 24, items: int = 40) -> pd.DataFrame:
    """A small log as ``examples/ml1m_parity.py`` reads one: sparse raw ids,
    per-user event positions as timestamps (the notebook's cumcount), a
    Zipf-skewed catalog with a successor chain, and a few items seen once."""
    rng = np.random.default_rng(seed)
    user_ids, item_ids = raw_ids("int", users, rng), raw_ids("int", items, rng)
    successor = rng.permutation(items)
    rows = []
    for user in range(users):
        length = int(rng.integers(6, 16))
        item = int(rng.integers(0, items - 4))
        for position in range(length):
            rows.append((user_ids[user], item_ids[item], position))
            item = int(successor[item]) if rng.random() < 0.6 else int(rng.zipf(1.5) % (items - 4))
    rows[5] = (rows[5][0], item_ids[-1], rows[5][2])  # one-off items: cold or dropped
    frame = pd.DataFrame(rows, columns=["user_id", "item_id", "timestamp"])
    return frame.sample(frac=1.0, random_state=seed).reset_index(drop=True)  # the log's order is not the time order


def notebook_front_end(m, log):
    """``ml1m_parity.py:78-112``: two last-one-out splits, the schemas, the
    tokenizer fitted on train and applied to the other three splits."""
    splitter = m["LastNSplitter"](
        N=1, divide_column="user_id", query_column="user_id", strategy="interactions",
        drop_cold_users=True, drop_cold_items=True,
    )
    test_events, test_gt = splitter.split(log)
    train_events, validation_gt = splitter.split(test_events)
    schema = m["FeatureSchema"]([
        m["FeatureInfo"]("user_id", m["FeatureType"].CATEGORICAL, m["FeatureHint"].QUERY_ID),
        m["FeatureInfo"]("item_id", m["FeatureType"].CATEGORICAL, m["FeatureHint"].ITEM_ID),
        m["FeatureInfo"]("timestamp", m["FeatureType"].NUMERICAL, m["FeatureHint"].TIMESTAMP),
    ])
    tensor = m["TensorSchema"](
        m["TensorFeatureInfo"](
            "item_id", m["FeatureType"].CATEGORICAL, is_seq=True, feature_hint=m["FeatureHint"].ITEM_ID,
            feature_sources=[m["TensorFeatureSource"](m["FeatureSource"].INTERACTIONS, "item_id")], embedding_dim=16,
        )
    )
    tokenizer = m["SequenceTokenizer"](tensor, handle_unknown_rule="drop")
    train = tokenizer.fit_transform(m["Dataset"](feature_schema=schema, interactions=train_events))
    rest = [tokenizer.transform(m["Dataset"](feature_schema=schema, interactions=part))
            for part in (validation_gt, test_events, test_gt)]
    return (test_events, test_gt, train_events, validation_gt), (train, *rest), tensor, tokenizer


@pytest.mark.parametrize("form", ["frame", "numpy"])
def test_notebook_front_end_is_bitwise_the_jax_one(form):
    log = notebook_frame()
    want_splits, want_sequences, want_schema, _ = notebook_front_end(JAX, log)
    given = log if form == "frame" else {name: log[name].to_numpy() for name in log.columns}
    got_splits, got_sequences, got_schema, tokenizer = notebook_front_end(PORT, given)
    for got, want in zip(got_splits, want_splits):
        assert_same_table(got, want.reset_index(drop=True))
    for got, want in zip(got_sequences, want_sequences):
        assert_same_sequences(got, want)
    cardinality = got_schema["item_id"].cardinality
    assert cardinality == want_schema["item_id"].cardinality
    assert cardinality < log["item_id"].nunique()  # an item seen only in a target was dropped
    # decoding the train sequences gives the train split's raw items, user by user
    train, train_events = got_sequences[0], got_splits[2]
    inverse = tokenizer.item_id_encoder.inverse_mapping["item_id"]
    users = tokenizer.query_id_encoder.inverse_mapping["user_id"]
    for index in range(len(train)):
        user = users[int(train.query_ids[index])]
        rows = np.flatnonzero(train_events["user_id"] == user)
        rows = rows[np.argsort(train_events["timestamp"][rows], kind="stable")]
        assert [inverse[int(c)] for c in train.get_sequence(index, "item_id")] == train_events["item_id"][rows].tolist()


NB_DIM, NB_LEN, NB_BATCH, NB_EPOCHS, NB_TOP_K = 16, 8, 8, 2, (1, 5, 10)


def test_notebook_pipeline_metrics_match_jax():
    """fit (2 epochs, monitor recall@10) and the test split's validate of
    both packages, from one frame through each front end, on the port's
    initial weights converted to flax: metrics within rtol 1e-4."""
    log = notebook_frame()
    metrics = {}
    for label, m in (("port", PORT), ("jax", JAX)):  # the port draws the initial weights
        _, (train, validation_gt, test_events, test_gt), schema, _ = notebook_front_end(m, log)
        width = dict(embedding_dim=NB_DIM, num_blocks=1, num_heads=2, max_sequence_length=NB_LEN, dropout_rate=0.0)
        if label == "port":
            pipes = {k: Compose(v) for k, v in make_default_sasrec_transforms(schema).items()}
            model = SasRec(schema, device="cpu", generator=torch.Generator().manual_seed(0), **width)
            initial = {name: value.detach().clone() for name, value in model.state_dict().items()}
            trainer = Trainer(model, CE(), optimizer=OptimizerFactory(name="adam", learning_rate=1e-2), device="cpu")
            batcher_cls, batches_fn = SequenceBatcher, validation_batches
            state = trainer.init_state(None, params=initial)
        else:
            pipes = {k: JaxCompose(v) for k, v in jax_sasrec_transforms(schema).items()}
            trainer = JaxTrainer(model=JaxSasRec(schema=schema, **width), loss=JaxCE(),
                                 optimizer=JaxOptimizerFactory(name="adam", learning_rate=1e-2))
            batcher_cls, batches_fn = JaxSequenceBatcher, jax_validation_batches
            state = None

        def train_batches(epoch, batcher_cls=batcher_cls, train=train, pipes=pipes):
            batcher = batcher_cls(train, batch_size=NB_BATCH, max_sequence_length=NB_LEN + 1, windows=True, shuffle=True, seed=0)
            batcher.set_epoch(epoch)
            return (pipes["train"](b) for b in batcher)

        def batches(history, truth, batches_fn=batches_fn, pipes=pipes):
            return (pipes["validate"](b) for b in batches_fn(history, truth, NB_BATCH, NB_LEN))

        if label == "jax":
            state = trainer.init_state(next(iter(train_batches(0))), params=torch_to_flax(initial))
        kwargs = dict(metrics=("ndcg", "recall", "map"), top_k=NB_TOP_K, item_count=schema["item_id"].cardinality)
        best = trainer.fit(
            train_batches, epochs=NB_EPOCHS, state=state, val_batches=lambda: batches(train, validation_gt),
            monitor="recall@10", log_every=0, **kwargs,
        )
        metrics[label] = (list(trainer.history), trainer.validate(best, batches(test_events, test_gt), **kwargs))
    (want_history, want_test), (got_history, got_test) = metrics["jax"], metrics["port"]
    assert len(got_history) == len(want_history) == NB_EPOCHS
    for got, want in zip(got_history, want_history):
        for key in ("train_loss", "recall@10", "ndcg@10", "map@10"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert got_test.keys() == want_test.keys()
    for key in want_test:
        np.testing.assert_allclose(got_test[key], want_test[key], rtol=1e-4, err_msg=key)
    assert got_test["recall@10"] > 0
