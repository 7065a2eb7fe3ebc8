"""Dataset-level categorical encoding.

A copy of ``replay_tpu/data/dataset_label_encoder.py`` on the port's
``Dataset`` and encoders: fits one encoding rule per categorical feature
against the tables where its column appears, transforms a
:class:`~replay_tpu_torch.data.dataset.Dataset` into an id-encoded one, and
exposes per-group sub-encoders (query ids, item ids, both).
"""

from __future__ import annotations

from typing import Optional, Sequence

from replay_tpu_torch.data.dataset import Dataset
from replay_tpu_torch.data.schema import FeatureSource, FeatureType
from replay_tpu_torch.preprocessing.label_encoder import (
    HandleUnknownStrategies,
    LabelEncoder,
    LabelEncodingRule,
    SequenceEncodingRule,
)


class DatasetLabelEncoder:
    """Encode every categorical feature of a Dataset into contiguous integer ids."""

    def __init__(
        self,
        handle_unknown_rule: HandleUnknownStrategies = "error",
        default_value_rule: Optional[int | str] = None,
    ) -> None:
        self._handle_unknown = handle_unknown_rule
        self._default_value = default_value_rule
        self._encoding_rules: dict[str, LabelEncodingRule] = {}
        self._columns_by_source: dict[FeatureSource, list[str]] = {}

    @property
    def interactions_encoder(self) -> Optional[LabelEncoder]:
        """Encoder over the columns present in the interactions frame."""
        return self._group_encoder_or_none(
            self._columns_by_source.get(FeatureSource.INTERACTIONS, [])
        )

    @property
    def query_features_encoder(self) -> Optional[LabelEncoder]:
        """Encoder over the columns present in the query-features frame."""
        return self._group_encoder_or_none(
            self._columns_by_source.get(FeatureSource.QUERY_FEATURES, [])
        )

    @property
    def item_features_encoder(self) -> Optional[LabelEncoder]:
        """Encoder over the columns present in the item-features frame."""
        return self._group_encoder_or_none(
            self._columns_by_source.get(FeatureSource.ITEM_FEATURES, [])
        )

    def _fitted_columns(self) -> Sequence[str]:
        return list(self._encoding_rules)

    # -- fitting ----------------------------------------------------------
    def fit(self, dataset: Dataset) -> "DatasetLabelEncoder":
        self._encoding_rules = {}
        self._columns_by_source = {}
        schema = dataset.feature_schema
        self._query_column_name = schema.query_id_column
        self._item_column_name = schema.item_id_column
        frames = {
            FeatureSource.INTERACTIONS: dataset.interactions,
            FeatureSource.QUERY_FEATURES: dataset.query_features,
            FeatureSource.ITEM_FEATURES: dataset.item_features,
        }
        for feature in schema.categorical_features.all_features:
            rule_cls = (
                SequenceEncodingRule
                if feature.feature_type == FeatureType.CATEGORICAL_LIST
                else LabelEncodingRule
            )
            rule = rule_cls(
                feature.column,
                handle_unknown=self._handle_unknown,
                default_value=self._default_value,
            )
            fitted = False
            # ids may appear in several frames; fit on interactions first, then extend
            for source in (FeatureSource.INTERACTIONS, FeatureSource.QUERY_FEATURES, FeatureSource.ITEM_FEATURES):
                frame = frames[source]
                if frame is None or feature.column not in frame.columns:
                    continue
                if not fitted:
                    rule.fit(frame)
                    fitted = True
                else:
                    rule.partial_fit(frame)
                self._columns_by_source.setdefault(source, []).append(feature.column)
            if fitted:
                self._encoding_rules[feature.column] = rule
        return self

    def partial_fit(self, dataset: Dataset) -> "DatasetLabelEncoder":
        if not self._encoding_rules:
            return self.fit(dataset)
        frames = {
            FeatureSource.INTERACTIONS: dataset.interactions,
            FeatureSource.QUERY_FEATURES: dataset.query_features,
            FeatureSource.ITEM_FEATURES: dataset.item_features,
        }
        for column, rule in self._encoding_rules.items():
            for source, frame in frames.items():
                if frame is not None and column in frame.columns:
                    rule.partial_fit(frame)
                    seen = self._columns_by_source.setdefault(source, [])
                    if column not in seen:  # a frame source first seen here
                        seen.append(column)
        return self

    # -- transforming -----------------------------------------------------
    def transform(self, dataset: Dataset) -> Dataset:
        if not self._encoding_rules:
            msg = "DatasetLabelEncoder is not fitted; call fit() first."
            raise RuntimeError(msg)

        def encode(frame):
            if frame is None:
                return None
            for column, rule in self._encoding_rules.items():
                if column in frame.columns:
                    frame = rule.transform(frame)
            return frame

        return Dataset(
            feature_schema=dataset.feature_schema.copy(),
            interactions=encode(dataset.interactions),
            query_features=encode(dataset.query_features),
            item_features=encode(dataset.item_features),
            check_consistency=False,
            categorical_encoded=True,
        )

    def fit_transform(self, dataset: Dataset) -> Dataset:
        return self.fit(dataset).transform(dataset)

    # -- sub-encoder views ------------------------------------------------
    def _group_encoder_or_none(self, columns: Sequence[str]) -> Optional[LabelEncoder]:
        rules = [self._encoding_rules[c] for c in columns if c in self._encoding_rules]
        return LabelEncoder(rules) if rules else None

    def _group_encoder(self, columns: Sequence[str]) -> LabelEncoder:
        encoder = self._group_encoder_or_none(columns)
        if encoder is None:
            msg = f"No fitted encoding rules among columns: {list(columns)}"
            raise RuntimeError(msg)
        return encoder

    def get_encoder(self, columns: Sequence[str]) -> Optional[LabelEncoder]:
        """Return a LabelEncoder over the requested fitted columns."""
        return self._group_encoder_or_none(columns)

    @property
    def query_id_encoder(self) -> LabelEncoder:
        return self._group_encoder([self._query_column_name])

    @property
    def item_id_encoder(self) -> LabelEncoder:
        return self._group_encoder([self._item_column_name])

    @property
    def query_and_item_id_encoder(self) -> LabelEncoder:
        return self._group_encoder([self._query_column_name, self._item_column_name])
