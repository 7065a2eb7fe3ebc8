"""Interactions plus optional query and item feature tables, without pandas.

Counterpart of ``replay_tpu/data/dataset.py``: the completed schema (sources
assigned, unlisted columns labelled NUMERICAL with a warning, lazy
cardinalities), the id-consistency and encoding checks, the unique ids and
their counts, and ``subset``. The JAX ``Dataset`` holds pandas frames; the
port holds :class:`~replay_tpu_torch.utils.types.ColumnTable` s, read from a
frame by duck type or from a mapping of numpy columns, and never imports
pandas. ``save``/``load`` (parquet) and the backend conversions are not
ported: each raises naming its ROADMAP.md item.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

import numpy as np

from replay_tpu_torch.data.schema import FeatureHint, FeatureInfo, FeatureSchema, FeatureSource, FeatureType
from replay_tpu_torch.utils.types import ColumnTable, as_table, is_frame

_NOT_PORTED = (
    "is not ported yet: ROADMAP.md queue 1, item 11, 'Classical and experimental models' "
    "(parquet and dataframe backends through pandas, which the card machine lacks)"
)


def flat_values(column: np.ndarray) -> np.ndarray:
    """A list column's elements in row order (pandas' ``explode``, less the
    missing values); a scalar column as it is."""
    if column.dtype != object or not any(isinstance(row, (list, tuple, np.ndarray)) for row in column):
        return column
    rows = [np.asarray(row) for row in column if row is not None]
    return np.concatenate(rows) if rows else np.empty(0)


def unique_in_order(values: np.ndarray) -> np.ndarray:
    """The distinct values in order of first appearance, as ``pd.unique``
    gives them: numeric columns through ``np.unique(return_index=True)``,
    others (strings, mixed types) through a dict."""
    values = np.asarray(values)
    if values.dtype != object:
        distinct, first = np.unique(values, return_index=True)
        return distinct[np.argsort(first, kind="stable")]
    distinct = list(dict.fromkeys(values.tolist()))
    out = np.empty(len(distinct), dtype=object)
    out[:] = distinct
    return out


def unique_count(values: np.ndarray) -> int:
    """Distinct values, missing ones left out (``Series.nunique``)."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        values = values[~np.isnan(values)]
    elif values.dtype == object:
        values = np.asarray([v for v in values.tolist() if v is not None and v == v], dtype=object)
    return len(unique_in_order(values))


class Dataset:
    """Interactions plus optional query and item feature tables.

    :param interactions: a frame (read by duck type), a
        :class:`~replay_tpu_torch.utils.types.ColumnTable`, or a mapping of
        column name to values; each feature table the same.
    """

    def __init__(
        self,
        feature_schema: FeatureSchema,
        interactions: Any,
        query_features: Optional[Any] = None,
        item_features: Optional[Any] = None,
        check_consistency: bool = True,
        categorical_encoded: bool = False,
    ) -> None:
        self._from_frame = is_frame(interactions)
        self._interactions = as_table(interactions)
        self._query_features = None if query_features is None else as_table(query_features)
        self._item_features = None if item_features is None else as_table(item_features)
        self._categorical_encoded = categorical_encoded

        try:
            feature_schema.query_id_column
        except ValueError as exc:
            msg = "Query id column is not set."
            raise ValueError(msg) from exc
        try:
            feature_schema.item_id_column
        except ValueError as exc:
            msg = "Item id column is not set."
            raise ValueError(msg) from exc

        self._feature_schema = self._complete_schema(feature_schema.copy())

        if check_consistency:
            if self._query_features is not None:
                self._check_ids_consistency(FeatureHint.QUERY_ID)
            if self._item_features is not None:
                self._check_ids_consistency(FeatureHint.ITEM_ID)
            if categorical_encoded:
                self._check_encoded()

    # -- basic properties -------------------------------------------------
    interactions = property(lambda self: self._interactions)
    query_features = property(lambda self: self._query_features)
    item_features = property(lambda self: self._item_features)
    feature_schema = property(lambda self: self._feature_schema)

    @property
    def is_categorical_encoded(self) -> bool:
        return self._categorical_encoded

    @property
    def is_pandas(self) -> bool:
        """Whether the interactions came as a dataframe (read by duck type)."""
        return self._from_frame

    @property
    def is_polars(self) -> bool:
        return False

    @property
    def is_spark(self) -> bool:
        return False

    def _frame_of(self, source: Optional[FeatureSource]) -> Optional[ColumnTable]:
        return {
            FeatureSource.INTERACTIONS: self._interactions,
            FeatureSource.QUERY_FEATURES: self._query_features,
            FeatureSource.ITEM_FEATURES: self._item_features,
            None: None,
        }[source]

    def _id_frame(self, hint: FeatureHint) -> ColumnTable:
        """The table an id column is counted over: its feature table where present."""
        if hint == FeatureHint.QUERY_ID and self._query_features is not None:
            return self._query_features
        if hint == FeatureHint.ITEM_ID and self._item_features is not None:
            return self._item_features
        return self._interactions

    @property
    def query_ids(self) -> ColumnTable:
        """The distinct query ids, sorted, as a one-column table."""
        column = self._feature_schema.query_id_column
        return ColumnTable({column: np.sort(unique_in_order(self._id_frame(FeatureHint.QUERY_ID)[column]))})

    @property
    def item_ids(self) -> ColumnTable:
        """The distinct item ids, sorted, as a one-column table."""
        column = self._feature_schema.item_id_column
        return ColumnTable({column: np.sort(unique_in_order(self._id_frame(FeatureHint.ITEM_ID)[column]))})

    @property
    def query_count(self) -> int:
        count = self._feature_schema.query_id_feature.cardinality
        if count is None:  # pragma: no cover - ids always have a callback
            raise RuntimeError("query id cardinality is unresolved")
        return count

    @property
    def item_count(self) -> int:
        count = self._feature_schema.item_id_feature.cardinality
        if count is None:  # pragma: no cover - ids always have a callback
            raise RuntimeError("item id cardinality is unresolved")
        return count

    # -- schema completion ------------------------------------------------
    def _complete_schema(self, schema: FeatureSchema) -> FeatureSchema:
        """Assign sources, label unlisted columns NUMERICAL, install cardinality callbacks."""
        tables = {
            FeatureSource.INTERACTIONS: self._interactions,
            FeatureSource.QUERY_FEATURES: self._query_features,
            FeatureSource.ITEM_FEATURES: self._item_features,
        }
        column_sources: dict[str, FeatureSource] = {}
        for source, table in tables.items():
            if table is None:
                continue
            for column in table.columns:
                column_sources.setdefault(column, source)

        features = list(schema.all_features)
        known = {f.column for f in features}
        qid = schema.query_id_column
        iid = schema.item_id_column

        for column, source in column_sources.items():
            if column not in known and column not in (qid, iid):
                warnings.warn(
                    f"Column '{column}' is not described in the feature schema; assuming NUMERICAL.",
                    stacklevel=3,
                )
                features.append(FeatureInfo(column=column, feature_type=FeatureType.NUMERICAL, feature_source=source))

        completed = FeatureSchema(features)
        for feature in completed.all_features:
            if feature.feature_source is None and feature.column in column_sources:
                feature._set_feature_source(column_sources[feature.column])
            if feature.feature_hint in (FeatureHint.QUERY_ID, FeatureHint.ITEM_ID):
                feature._set_feature_source(FeatureSource.INTERACTIONS)
            if feature.feature_type.is_categorical:
                feature._set_cardinality_callback(self._make_cardinality_callback(feature))
        return completed

    def _make_cardinality_callback(self, feature: FeatureInfo):
        hint = feature.feature_hint

        def callback(column: str) -> int:
            if hint in (FeatureHint.QUERY_ID, FeatureHint.ITEM_ID):
                values = self._id_frame(hint)[column]
                if self._categorical_encoded:
                    # encoded ids are contiguous [0, n): the cardinality is max + 1
                    return int(np.max(values)) + 1
                return unique_count(values)
            table = self._frame_of(feature.feature_source) if feature.feature_source else self._interactions
            values = table[column]
            if feature.feature_type == FeatureType.CATEGORICAL_LIST:
                values = flat_values(values)
            return unique_count(values)

        return callback

    # -- consistency ------------------------------------------------------
    def _check_ids_consistency(self, hint: FeatureHint) -> None:
        features_table = self._query_features if hint == FeatureHint.QUERY_ID else self._item_features
        column = (
            self._feature_schema.query_id_column if hint == FeatureHint.QUERY_ID else self._feature_schema.item_id_column
        )
        inter_ids = set(self._interactions[column].tolist())
        feat_ids = set(features_table[column].tolist())
        missing = inter_ids - feat_ids
        if missing:
            msg = f"{len(missing)} {hint.value}s from interactions are absent in the feature frame."
            raise ValueError(msg)

    def _check_encoded(self) -> None:
        for feature in self._feature_schema.categorical_features.all_features:
            table = self._frame_of(feature.feature_source)
            if table is None:
                continue
            values = table[feature.column]
            if feature.feature_type == FeatureType.CATEGORICAL_LIST:
                values = flat_values(values)
            if values.size == 0:
                continue
            if not np.issubdtype(np.asarray(values).dtype, np.integer):
                msg = f"Column '{feature.column}' is declared encoded but is not integer-typed."
                raise ValueError(msg)
            if int(values.min()) < 0:
                msg = f"Column '{feature.column}' is declared encoded but contains negative ids."
                raise ValueError(msg)

    # -- structural ops ---------------------------------------------------
    def subset(self, features_to_keep) -> "Dataset":
        """Project every table onto the requested feature columns (+ id columns)."""
        keep = set(features_to_keep)
        keep.add(self._feature_schema.query_id_column)
        keep.add(self._feature_schema.item_id_column)
        schema = self._feature_schema.subset(keep)

        def project(table):
            if table is None:
                return None
            return table[[c for c in table.columns if c in keep]]

        item_table = project(self._item_features)
        query_table = project(self._query_features)
        if item_table is not None and len(item_table.columns) <= 1:
            item_table = None
            schema = schema.drop(feature_source=FeatureSource.ITEM_FEATURES)
        if query_table is not None and len(query_table.columns) <= 1:
            query_table = None
            schema = schema.drop(feature_source=FeatureSource.QUERY_FEATURES)

        subset = Dataset(
            feature_schema=schema,
            interactions=project(self._interactions),
            query_features=query_table,
            item_features=item_table,
            check_consistency=False,
            categorical_encoded=self._categorical_encoded,
        )
        subset._from_frame = self._from_frame
        return subset

    # -- not ported -------------------------------------------------------
    def save(self, path: str) -> None:
        """Not ported: the JAX package writes parquet through pandas."""
        raise NotImplementedError(f"Dataset.save {_NOT_PORTED}")

    @classmethod
    def load(cls, path: str, dataframe_type: Optional[str] = None) -> "Dataset":
        """Not ported: the JAX package reads parquet through pandas."""
        raise NotImplementedError(f"Dataset.load {_NOT_PORTED}")

    def to_pandas(self) -> "Dataset":
        """Not ported: the port holds numpy columns (``ColumnTable.to_numpy``)."""
        raise NotImplementedError(f"Dataset.to_pandas {_NOT_PORTED}")

    def to_polars(self) -> "Dataset":
        """Not ported, as :meth:`to_pandas`."""
        raise NotImplementedError(f"Dataset.to_polars {_NOT_PORTED}")

    def to_spark(self) -> "Dataset":
        """Not ported, as :meth:`to_pandas`."""
        raise NotImplementedError(f"Dataset.to_spark {_NOT_PORTED}")


def nunique(table, column: str) -> int:
    """Number of distinct values of ``column``."""
    return unique_count(as_table(table)[column])


def select(table, columns) -> ColumnTable:
    """Project onto ``columns``."""
    return as_table(table)[list(columns)]
