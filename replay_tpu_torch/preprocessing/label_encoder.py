"""Categorical label encoding into contiguous integer ids, without pandas.

Counterpart of ``replay_tpu/preprocessing/label_encoder.py``: a per-column
``LabelEncodingRule`` with fit / partial_fit / transform / inverse_transform,
the unknown-label strategies ``error`` / ``use_default_value`` / ``drop`` (the
default value may be ``"last"``), ``SequenceEncodingRule`` for list columns,
and ``LabelEncoder`` composing rules, with JSON ``save``/``load`` in the JAX
package's layout. Codes follow first appearance, as ``pd.unique`` orders
labels. Tables come in as frames (by duck type), ``ColumnTable`` s or
mappings of columns, and go out as ``ColumnTable`` s.
"""

from __future__ import annotations

import json
import warnings
from collections.abc import Mapping, Sequence
from pathlib import Path
from typing import Any, Literal, Optional, Tuple, Union

import numpy as np

from replay_tpu_torch.data.dataset import flat_values, unique_in_order
from replay_tpu_torch.utils.serde import to_plain
from replay_tpu_torch.utils.types import ColumnTable, as_table

HandleUnknownStrategies = Literal["error", "use_default_value", "drop"]
_STRATEGIES = ("error", "use_default_value", "drop")


class LabelEncoderTransformWarning(Warning):
    """Warning raised on lossy transform behavior (dropping unknown labels)."""


class LabelEncoderPartialFitWarning(Warning):
    """Warning raised when partial_fit is called before fit."""


def _labels_array(labels: list) -> np.ndarray:
    """Labels as one array: their common numeric dtype, else objects."""
    array = np.asarray(labels) if labels else np.empty(0, dtype=object)
    if array.dtype.kind in "biuf" and array.ndim == 1:
        return array
    out = np.empty(len(labels), dtype=object)
    out[:] = labels
    return out


class LabelEncodingRule:
    """Encode one scalar column's values into contiguous ids ``[0, n)``."""

    def __init__(
        self,
        column: str,
        mapping: Optional[Mapping] = None,
        handle_unknown: HandleUnknownStrategies = "error",
        default_value: Union[int, str, None] = None,
    ) -> None:
        if handle_unknown not in _STRATEGIES:
            msg = f"handle_unknown must be one of {_STRATEGIES}, got {handle_unknown!r}."
            raise ValueError(msg)
        if (
            handle_unknown == "use_default_value"
            and default_value is not None
            and not isinstance(default_value, int)
            and default_value != "last"
        ):
            msg = "default_value must be int, None or 'last'."
            raise ValueError(msg)
        self._column = column
        self._handle_unknown = handle_unknown
        self._default_value = default_value
        self._mapping: Optional[dict] = dict(mapping) if mapping is not None else None
        self._lookup: Optional[Tuple[np.ndarray, np.ndarray]] = None

    # -- properties -------------------------------------------------------
    @property
    def column(self) -> str:
        return self._column

    @property
    def is_fitted(self) -> bool:
        return self._mapping is not None

    def get_mapping(self) -> Mapping:
        self._require_fitted()
        return self._mapping

    def get_inverse_mapping(self) -> Mapping:
        self._require_fitted()
        return {code: label for label, code in self._mapping.items()}

    def _require_fitted(self):
        if self._mapping is None:
            msg = f"LabelEncodingRule for '{self._column}' is not fitted."
            raise RuntimeError(msg)

    def _inverse_array(self) -> np.ndarray:
        """Labels by code."""
        labels = [None] * len(self._mapping)
        for label, code in self._mapping.items():
            labels[code] = label
        return _labels_array(labels)

    # -- column value access (overridden by SequenceEncodingRule) ---------
    def _values(self, table: ColumnTable) -> np.ndarray:
        return table[self._column]

    def _flat_values(self, table: ColumnTable) -> np.ndarray:
        return self._values(table)

    # -- fitting ----------------------------------------------------------
    def fit(self, df: Any) -> "LabelEncodingRule":
        values = unique_in_order(self._flat_values(as_table(df)))
        self._mapping = {label: code for code, label in enumerate(values.tolist())}
        self._lookup = None
        if self._handle_unknown == "use_default_value" and self._default_value in self._mapping:
            warnings.warn(
                f"default_value {self._default_value} collides with an encoded label.",
                LabelEncoderTransformWarning,
                stacklevel=2,
            )
        return self

    def partial_fit(self, df: Any) -> "LabelEncodingRule":
        if self._mapping is None:
            warnings.warn(
                "partial_fit called before fit; falling back to fit.",
                LabelEncoderPartialFitWarning,
                stacklevel=2,
            )
            return self.fit(df)
        next_code = len(self._mapping)
        for label in unique_in_order(self._flat_values(as_table(df))).tolist():
            if label not in self._mapping:
                self._mapping[label] = next_code
                next_code += 1
        self._lookup = None
        return self

    # -- encoding ---------------------------------------------------------
    def _codes(self, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Each value's code (-1 where unknown) and the unknown mask: numeric
        values by a binary search over the sorted labels, others by the dict."""
        values = np.asarray(values)
        if values.dtype.kind in "biuf":
            if self._lookup is None:
                labels = _labels_array(list(self._mapping))
                if labels.dtype == object:  # mixed labels: no sorted order
                    self._lookup = (labels, np.empty(0, np.int64))
                else:
                    order = np.argsort(labels, kind="stable")
                    codes = np.fromiter(self._mapping.values(), np.int64, len(self._mapping))
                    self._lookup = (labels[order], codes[order])
            labels, codes = self._lookup
            if labels.dtype != object:
                if not len(labels):
                    return np.full(len(values), -1, np.int64), np.ones(len(values), bool)
                at = np.minimum(np.searchsorted(labels, values), len(labels) - 1)
                known = labels[at] == values
                return np.where(known, codes[at], -1).astype(np.int64), ~known
        mapping = self._mapping
        out = np.fromiter((mapping.get(v, -1) for v in values.tolist()), np.int64, len(values))
        unknown = np.fromiter((v not in mapping for v in values.tolist()), bool, len(values))
        return out, unknown

    def _default(self) -> int:
        default = len(self._mapping) if self._default_value == "last" else self._default_value
        return -1 if default is None else default

    def _encode_array(self, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        codes, unknown = self._codes(values)
        if unknown.any():
            if self._handle_unknown == "error":
                unknown_labels = unique_in_order(np.asarray(values)[unknown])
                msg = f"Found unknown labels in column '{self._column}': {list(unknown_labels)[:10]}"
                raise ValueError(msg)
            codes = np.where(unknown, self._default(), codes).astype(np.int64)
        return codes, unknown

    def transform(self, df: Any) -> ColumnTable:
        self._require_fitted()
        table = as_table(df)
        codes, unknown = self._encode_array(self._values(table))
        result = table.assign(**{self._column: codes})
        if unknown.any() and self._handle_unknown == "drop":
            result = result.take(~unknown)
            if result.empty:
                warnings.warn(
                    f"Transform of column '{self._column}' with handle_unknown='drop' produced an empty dataframe.",
                    LabelEncoderTransformWarning,
                    stacklevel=2,
                )
        return result

    def _decode(self, codes: np.ndarray) -> np.ndarray:
        """Labels of ``codes``; ``None`` where a code is out of range."""
        inverse = self._inverse_array()
        codes = np.asarray(codes, dtype=np.int64)
        inside = (codes >= 0) & (codes < len(inverse))
        if inside.all():
            return inverse[codes]
        out = np.empty(len(codes), dtype=object)
        out[inside] = inverse[codes[inside]]
        return out

    def inverse_transform(self, df: Any) -> ColumnTable:
        self._require_fitted()
        table = as_table(df)
        return table.assign(**{self._column: self._decode(table[self._column])})

    # -- configuration ----------------------------------------------------
    def set_default_value(self, default_value: Union[int, str, None]) -> None:
        if default_value is not None and not isinstance(default_value, int) and default_value != "last":
            msg = "default_value must be int, None or 'last'."
            raise ValueError(msg)
        self._default_value = default_value

    def set_handle_unknown(self, handle_unknown: HandleUnknownStrategies) -> None:
        if handle_unknown not in _STRATEGIES:
            msg = f"handle_unknown must be one of {_STRATEGIES}, got {handle_unknown!r}."
            raise ValueError(msg)
        self._handle_unknown = handle_unknown

    # -- persistence -------------------------------------------------------
    def _as_dict(self) -> dict:
        return {
            "_rule": type(self).__name__,
            "column": self._column,
            "handle_unknown": self._handle_unknown,
            "default_value": self._default_value,
            "mapping": [[to_plain(label), int(code)] for label, code in self._mapping.items()]
            if self._mapping is not None
            else None,
        }

    @classmethod
    def _from_dict(cls, data: dict) -> "LabelEncodingRule":
        rule_cls = _RULE_CLASSES[data["_rule"]]
        return rule_cls(
            data["column"],
            mapping={label: code for label, code in data["mapping"]} if data["mapping"] is not None else None,
            handle_unknown=data["handle_unknown"],
            default_value=data["default_value"],
        )

    def save(self, path: str) -> None:
        """One rule as a ``.replay`` artefact (``init_args.json``)."""
        target = Path(path).with_suffix(".replay")
        target.mkdir(parents=True, exist_ok=True)
        (target / "init_args.json").write_text(json.dumps(self._as_dict()))

    @classmethod
    def load(cls, path: str) -> "LabelEncodingRule":
        source = Path(path).with_suffix(".replay")
        return cls._from_dict(json.loads((source / "init_args.json").read_text()))


class SequenceEncodingRule(LabelEncodingRule):
    """Encode a list-typed column element-wise with one shared mapping."""

    def _flat_values(self, table: ColumnTable) -> np.ndarray:
        values = flat_values(table[self._column])
        if values.dtype.kind == "f":
            return values[~np.isnan(values)]
        if values.dtype == object:
            return values[np.fromiter((v is not None and v == v for v in values.tolist()), bool, len(values))]
        return values

    def transform(self, df: Any) -> ColumnTable:
        self._require_fitted()
        table = as_table(df)
        rows = [np.asarray(row) for row in table[self._column]]
        lengths = np.fromiter((len(row) for row in rows), np.int64, len(rows))
        flat = np.concatenate(rows) if rows else np.empty(0, np.int64)
        codes, unknown = self._codes(flat)
        handle = self._handle_unknown
        if unknown.any():
            if handle == "error":
                label = flat[np.argmax(unknown)]
                msg = f"Found unknown label {label!r} in list column '{self._column}'"
                raise ValueError(msg)
            if handle == "drop":
                row_of = np.repeat(np.arange(len(rows)), lengths)
                lengths = np.bincount(row_of[~unknown], minlength=len(rows))
                codes = codes[~unknown]
            else:
                codes = np.where(unknown, self._default(), codes).astype(np.int64)
        column = np.empty(len(rows), dtype=object)
        for index, row in enumerate(np.split(codes, np.cumsum(lengths)[:-1]) if len(rows) else []):
            column[index] = row
        if unknown.any() and handle == "drop" and len(rows) and not lengths.any():
            warnings.warn(
                f"Transform of list column '{self._column}' with handle_unknown='drop' dropped every element.",
                LabelEncoderTransformWarning,
                stacklevel=2,
            )
        return table.assign(**{self._column: column})

    def inverse_transform(self, df: Any) -> ColumnTable:
        self._require_fitted()
        table = as_table(df)
        column = np.empty(len(table), dtype=object)
        for index, row in enumerate(table[self._column]):
            decoded = self._decode(np.asarray(row))
            column[index] = decoded.astype(object) if decoded.dtype != object else decoded
        return table.assign(**{self._column: column})


class LabelEncoder:
    """Apply a set of encoding rules column-wise to a table."""

    def __init__(self, rules: Sequence[LabelEncodingRule]) -> None:
        self.rules = list(rules)

    @property
    def mapping(self) -> Mapping[str, Mapping]:
        return {rule.column: rule.get_mapping() for rule in self.rules}

    @property
    def inverse_mapping(self) -> Mapping[str, Mapping]:
        return {rule.column: rule.get_inverse_mapping() for rule in self.rules}

    def fit(self, df: Any) -> "LabelEncoder":
        table = as_table(df)
        for rule in self.rules:
            rule.fit(table)
        return self

    def partial_fit(self, df: Any) -> "LabelEncoder":
        table = as_table(df)
        for rule in self.rules:
            rule.partial_fit(table)
        return self

    def transform(self, df: Any) -> ColumnTable:
        table = as_table(df)
        for rule in self.rules:
            table = rule.transform(table)
        return table

    def inverse_transform(self, df: Any) -> ColumnTable:
        table = as_table(df)
        for rule in self.rules:
            table = rule.inverse_transform(table)
        return table

    def fit_transform(self, df: Any) -> ColumnTable:
        table = as_table(df)
        return self.fit(table).transform(table)

    def set_default_values(self, default_value_rules: Mapping[str, Union[int, str, None]]) -> None:
        by_column = {rule.column: rule for rule in self.rules}
        for column, value in default_value_rules.items():
            if column not in by_column:
                msg = f"No encoding rule for column '{column}'."
                raise ValueError(msg)
            by_column[column].set_default_value(value)

    def set_handle_unknowns(self, handle_unknown_rules: Mapping[str, HandleUnknownStrategies]) -> None:
        by_column = {rule.column: rule for rule in self.rules}
        for column, value in handle_unknown_rules.items():
            if column not in by_column:
                msg = f"No encoding rule for column '{column}'."
                raise ValueError(msg)
            by_column[column].set_handle_unknown(value)

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        """Rules and fitted mappings to ``<path>.replay/init_args.json``."""
        target = Path(path).with_suffix(".replay")
        target.mkdir(parents=True, exist_ok=True)
        payload = {"_class_name": "LabelEncoder", "rules": [r._as_dict() for r in self.rules]}
        (target / "init_args.json").write_text(json.dumps(payload))

    @classmethod
    def load(cls, path: str) -> "LabelEncoder":
        source = Path(path).with_suffix(".replay")
        payload = json.loads((source / "init_args.json").read_text())
        return cls([LabelEncodingRule._from_dict(spec) for spec in payload["rules"]])


_RULE_CLASSES = {
    "LabelEncodingRule": LabelEncodingRule,
    "SequenceEncodingRule": SequenceEncodingRule,
}
