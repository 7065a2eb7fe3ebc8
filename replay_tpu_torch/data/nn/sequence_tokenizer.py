"""Dataset → per-query sequences, without pandas.

Counterpart of ``replay_tpu/data/nn/sequence_tokenizer.py``: ``fit`` checks
the tensor schema against a :class:`~replay_tpu_torch.data.dataset.Dataset`,
fits a :class:`~replay_tpu_torch.data.dataset_label_encoder.DatasetLabelEncoder`
over its categorical features and gives each categorical tensor feature the
cardinality of its fitted mapping; ``transform`` encodes the dataset, sorts
the interactions by (query, timestamp) stably, groups them by query in
ascending order and returns one array per (query, feature) as a
:class:`SequentialDataset`. ``save``/``load`` write and read the JAX
package's JSON layout (the schema and the fitted mappings).

The JAX version sorts, joins and groups with pandas (``sort_values``,
``map``, ``groupby``); the port does the same on numpy: ``lexsort`` (stable),
a binary search over the item table's ids for the item-side join, and the
boundaries of the sorted query column for the groups.

Sources per feature (its ``TensorFeatureSource``):
* INTERACTIONS + is_seq: a sequence column (item ids, ratings, …);
* ITEM_FEATURES + is_seq: the item-side value of each item of the sequence;
* QUERY_FEATURES, non-seq: one scalar per query.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from replay_tpu_torch.data.dataset import Dataset
from replay_tpu_torch.data.dataset_label_encoder import DatasetLabelEncoder
from replay_tpu_torch.data.nn.schema import TensorSchema
from replay_tpu_torch.data.nn.sequential_dataset import SequentialDataset
from replay_tpu_torch.data.schema import FeatureSource
from replay_tpu_torch.preprocessing.label_encoder import HandleUnknownStrategies, LabelEncodingRule


def _lookup(keys: np.ndarray, table_keys: np.ndarray, table_values: np.ndarray) -> np.ndarray:
    """``table_values`` at the row of ``table_keys`` equal to each of
    ``keys`` (the last such row where a key repeats); NaN, or ``None`` for
    object values, where a key is absent (``Series.map`` of a keyed series)."""
    order = np.argsort(table_keys, kind="stable")
    sorted_keys = table_keys[order]
    at = np.searchsorted(sorted_keys, keys, side="right") - 1
    found = (at >= 0) & (sorted_keys[np.maximum(at, 0)] == keys)
    picked = table_values[order[np.maximum(at, 0)]] if len(order) else np.empty(len(keys), table_values.dtype)
    if found.all():
        return picked
    if picked.dtype == object:
        picked = picked.copy()
        picked[~found] = None
        return picked
    picked = picked.astype(np.float64)
    picked[~found] = np.nan
    return picked


class SequenceTokenizer:
    """Fit/transform bridge from interaction tables to model sequences."""

    def __init__(
        self,
        tensor_schema: TensorSchema,
        handle_unknown_rule: HandleUnknownStrategies = "error",
        default_value_rule: Optional[int | str] = None,
    ) -> None:
        self._schema = tensor_schema
        self._handle_unknown = handle_unknown_rule
        self._default_value = default_value_rule
        self._encoder = DatasetLabelEncoder(handle_unknown_rule=handle_unknown_rule, default_value_rule=default_value_rule)
        self._fitted = False

    tensor_schema = property(lambda self: self._schema)

    @property
    def interactions_encoder(self):
        """Encoder over interaction-table columns."""
        return self._encoder.interactions_encoder

    @property
    def query_features_encoder(self):
        return self._encoder.query_features_encoder

    @property
    def item_features_encoder(self):
        return self._encoder.item_features_encoder

    @property
    def query_id_encoder(self):
        return self._encoder.query_id_encoder

    @property
    def item_id_encoder(self):
        return self._encoder.item_id_encoder

    @property
    def query_and_item_id_encoder(self):
        return self._encoder.query_and_item_id_encoder

    def encode(self, dataset: Dataset) -> Dataset:
        """Id-encode a Dataset with the fitted rules without sequencing it."""
        if not self._fitted:
            msg = "SequenceTokenizer is not fitted; call fit() first."
            raise RuntimeError(msg)
        return self._encoder.transform(dataset)

    # -- fit ---------------------------------------------------------------- #
    def fit(self, dataset: Dataset) -> "SequenceTokenizer":
        self._check_schema_against(dataset)
        self._encoder.fit(dataset)
        # cardinalities from the fitted mappings, so padding defaults resolve
        for feature in self._schema.all_features:
            if feature.is_cat and feature.cardinality is None:
                source = feature.feature_source
                if source is not None:
                    rule = self._encoder._encoding_rules.get(source.column)
                    if rule is not None:
                        feature._set_cardinality(len(rule.get_mapping()))
        self._fitted = True
        return self

    def _check_schema_against(self, dataset: Dataset) -> None:
        tables = {
            FeatureSource.INTERACTIONS: dataset.interactions,
            FeatureSource.QUERY_FEATURES: dataset.query_features,
            FeatureSource.ITEM_FEATURES: dataset.item_features,
        }
        for feature in self._schema.all_features:
            source = feature.feature_source
            if source is None:
                continue
            table = tables.get(source.source)
            if table is None:
                msg = f"Feature '{feature.name}' sources {source.source}, absent from dataset."
                raise ValueError(msg)
            if source.column not in table.columns:
                msg = f"Column '{source.column}' for feature '{feature.name}' not found."
                raise ValueError(msg)

    # -- transform ----------------------------------------------------------- #
    def transform(self, dataset: Dataset, tensor_features_to_keep: Optional[Sequence[str]] = None) -> SequentialDataset:
        if not self._fitted:
            msg = "SequenceTokenizer is not fitted; call fit() first."
            raise RuntimeError(msg)
        schema = self._schema.subset(tensor_features_to_keep) if tensor_features_to_keep is not None else self._schema
        encoded = self._encoder.transform(dataset)
        query_col = dataset.feature_schema.query_id_column
        ts_col = dataset.feature_schema.interactions_timestamp_column
        interactions = encoded.interactions
        queries = interactions[query_col]
        # stable sort by (query, timestamp): equal timestamps keep the log's order
        order = np.lexsort((interactions[ts_col], queries)) if ts_col else np.argsort(queries, kind="stable")
        interactions = interactions.take(order)
        queries = interactions[query_col]

        # groups in ascending query order, each a contiguous run of the sorted log
        query_order, starts = np.unique(queries, return_index=True)
        bounds = starts[1:]

        def grouped(values: np.ndarray) -> np.ndarray:
            column = np.empty(len(query_order), dtype=object)
            for index, run in enumerate(np.split(values, bounds) if len(query_order) else []):
                column[index] = run
            return column

        data: Dict[str, np.ndarray] = {query_col: query_order}
        item_col = dataset.feature_schema.item_id_column
        for feature in schema.all_features:
            source = feature.feature_source
            if feature.is_seq:
                if source is not None and source.source == FeatureSource.ITEM_FEATURES:
                    items = encoded.item_features
                    values = _lookup(interactions[item_col], items[item_col], items[source.column])
                else:
                    values = interactions[source.column if source else feature.name]
                data[feature.name] = grouped(values)
            else:
                if source is None or source.source != FeatureSource.QUERY_FEATURES:
                    msg = f"Non-sequential feature '{feature.name}' must source QUERY_FEATURES (one value per query)."
                    raise ValueError(msg)
                table = encoded.query_features
                data[feature.name] = _lookup(query_order, table[query_col], table[source.column])

        return SequentialDataset(
            tensor_schema=schema,
            query_id_column=query_col,
            item_id_column=schema.item_id_feature_name,
            sequences=data,
        )

    def fit_transform(self, dataset: Dataset, tensor_features_to_keep: Optional[Sequence[str]] = None) -> SequentialDataset:
        return self.fit(dataset).transform(dataset, tensor_features_to_keep)

    # -- persistence --------------------------------------------------------- #
    def save(self, path: str) -> None:
        target = Path(path).with_suffix(".replay")
        target.mkdir(parents=True, exist_ok=True)
        (target / "init_args.json").write_text(
            json.dumps(
                {
                    "_class_name": "SequenceTokenizer",
                    "handle_unknown_rule": self._handle_unknown,
                    "default_value_rule": self._default_value,
                    "fitted": self._fitted,
                }
            )
        )
        (target / "schema.json").write_text(self._schema.to_json())
        mappings = {column: rule._as_dict() for column, rule in self._encoder._encoding_rules.items()}
        (target / "encoder_mappings.json").write_text(json.dumps(mappings))
        columns = {
            "query": getattr(self._encoder, "_query_column_name", None),
            "item": getattr(self._encoder, "_item_column_name", None),
            "by_source": {source.name: cols for source, cols in self._encoder._columns_by_source.items()},
        }
        (target / "encoder_columns.json").write_text(json.dumps(columns))

    @classmethod
    def load(cls, path: str) -> "SequenceTokenizer":
        source = Path(path).with_suffix(".replay")
        args = json.loads((source / "init_args.json").read_text())
        schema = TensorSchema.from_json((source / "schema.json").read_text())
        tokenizer = cls(schema, handle_unknown_rule=args["handle_unknown_rule"], default_value_rule=args["default_value_rule"])
        mappings = json.loads((source / "encoder_mappings.json").read_text())
        for column, spec in mappings.items():
            if isinstance(spec, list):  # the older layout: [[label, code], ...]
                rule = LabelEncodingRule(
                    column,
                    mapping={label: code for label, code in spec},
                    handle_unknown=args["handle_unknown_rule"],
                    default_value=args["default_value_rule"],
                )
            else:
                rule = LabelEncodingRule._from_dict(spec)
            tokenizer._encoder._encoding_rules[column] = rule
        columns = json.loads((source / "encoder_columns.json").read_text())
        tokenizer._encoder._query_column_name = columns["query"]
        tokenizer._encoder._item_column_name = columns["item"]
        tokenizer._encoder._columns_by_source = {
            FeatureSource[name]: cols for name, cols in columns.get("by_source", {}).items()
        }
        tokenizer._fitted = args["fitted"]
        return tokenizer
