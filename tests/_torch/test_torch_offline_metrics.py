"""The port's offline metrics against the JAX package's, on the CPU.

One set of inputs, drawn from a seed with numpy, goes through both packages'
metric classes in three forms: dicts (``{query: [(item, score), ...]}``),
pandas frames (read by the port by duck type) and the port's ``ColumnTable``
(the JAX package reads the same columns as a pandas frame). The inputs hold
ties in rating and in item, NaN ratings, duplicated and ``None`` items, users
with an empty list and users absent from the recommendations. Every metric
class under ``Mean``, ``PerUser``, ``Median`` and ``ConfidenceInterval(0.95)``
is held to 1e-12, ``PerUser`` dicts key for key and in the same key order; the
order of the items within a user and of the users is asserted exactly.
``OfflineMetrics`` (Unexpectedness against several base models,
``CategoricalDiversity``, ``NCISPrecision``), ``Experiment``,
``metrics_to_df`` and ``MetricsBuilder.load_state`` close the file.
"""

import math
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import replay_tpu.metrics as jm
import replay_tpu_torch.metrics as pm
from replay_tpu.metrics.builder import MetricsBuilder as JaxMetricsBuilder
from replay_tpu_torch.utils.types import ColumnTable

TOL = 1e-12
KS = [1, 3, 5]
MODES = ("Mean", "PerUser", "Median", "ConfidenceInterval")
FORMS = ("dict", "pandas", "table")


def _frames(seed: int = 0):
    """Recommendations, ground truth, train, two base models and the logged
    policy, as pandas frames."""
    rng = np.random.default_rng(seed)
    rows = []
    for query in range(30):
        if query % 7 == 3:  # absent from the recommendations
            continue
        for _ in range(int(rng.integers(1, 9))):
            item = int(rng.integers(0, 12))  # duplicates within a user
            rating = float(np.round(rng.random(), 1))  # ties in rating
            rows.append((query, item, rating))
    rows.append((40, 2, 0.5))  # a query without ground truth
    recs = pd.DataFrame(rows, columns=["query_id", "item_id", "rating"])
    recs.loc[rng.random(len(recs)) < 0.06, "rating"] = np.nan
    items = recs["item_id"].astype(object)
    items[rng.random(len(recs)) < 0.04] = None
    recs["item_id"] = items
    recs["category_id"] = rng.integers(0, 4, len(recs))
    gt = pd.DataFrame(
        [(q, int(rng.integers(0, 12))) for q in range(34) for _ in range(int(rng.integers(1, 4)))],
        columns=["query_id", "item_id"],
    )
    train = pd.DataFrame(
        [(q, int(rng.integers(0, 16))) for q in range(34) for _ in range(int(rng.integers(1, 6)))],
        columns=["query_id", "item_id"],
    )

    def base(shift):
        frame = recs[["query_id", "item_id"]].copy()
        frame["item_id"] = frame["item_id"].map(lambda x: None if x is None else (x + shift) % 12)
        frame["rating"] = rng.random(len(frame))
        return frame

    prev = recs.sample(frac=0.7, random_state=seed)[["query_id", "item_id", "rating"]].copy()
    prev["rating"] = rng.random(len(prev)) * 2 - 0.5
    prev.loc[prev.index[:3], "rating"] = 0.0
    return {"recs": recs, "gt": gt, "train": train, "base_a": base(1), "base_b": base(5), "prev": prev}


def _as_dict(frame, scored: bool, item: str = "item_id"):
    """``{query: [(item, score), ...]}`` (or ``[item, ...]``) in row order."""
    out = {}
    for row in frame.itertuples(index=False):
        value = (getattr(row, item), row.rating) if scored else getattr(row, item)
        out.setdefault(row.query_id, []).append(value)
    return out


def _as_table(frame):
    return ColumnTable({name: frame[name].to_numpy() for name in frame.columns})


@pytest.fixture(scope="module")
def inputs():
    frames = _frames()
    forms = {"pandas": frames}
    forms["table"] = {name: _as_table(frame) for name, frame in frames.items()}
    forms["dict"] = {
        "recs": {**_as_dict(frames["recs"], True), 50: []},  # an empty list
        "gt": {**_as_dict(frames["gt"], False), 51: []},
        "train": _as_dict(frames["train"], False),
        "base_a": _as_dict(frames["base_a"], True),
        "base_b": _as_dict(frames["base_b"], True),
        "categories": _as_dict(frames["recs"], True, item="category_id"),
    }
    return forms


def _jax_side(value):
    """What the JAX package takes for ``value``: a table becomes the pandas
    frame of its columns; dicts and frames stay."""
    if isinstance(value, ColumnTable):
        return pd.DataFrame(value.to_numpy())
    return value


def _mode(module, name):
    return module.ConfidenceInterval(0.95) if name == "ConfidenceInterval" else getattr(module, name)()


def _close(got, want) -> bool:
    return (math.isnan(got) and math.isnan(want)) or abs(got - want) <= TOL


def _assert_same(got, want):
    """The same keys in the same order, values within TOL (PerUser dicts
    user by user, in the same order); at least one value finite."""
    assert list(got) == list(want)
    values = []
    for key in want:
        if isinstance(want[key], dict):
            assert list(got[key]) == list(want[key]), key
            for user in want[key]:
                assert _close(got[key][user], want[key][user]), (key, user)
            values.extend(want[key].values())
        else:
            assert _close(got[key], want[key]), (key, got[key], want[key])
            values.append(want[key])
    assert any(math.isfinite(v) for v in values)


# metric name -> (constructor kwargs, call arguments by input name)
METRICS = {
    "HitRate": ({}, ("recs", "gt")),
    "Precision": ({}, ("recs", "gt")),
    "Recall": ({}, ("recs", "gt")),
    "MAP": ({}, ("recs", "gt")),
    "MRR": ({}, ("recs", "gt")),
    "NDCG": ({}, ("recs", "gt")),
    "RocAuc": ({}, ("recs", "gt")),
    "Novelty": ({}, ("recs", "train")),
    "Surprisal": ({}, ("recs", "train")),
    "Unexpectedness": ({}, ("recs", "base_a")),
    "CategoricalDiversity": ({}, ("categories",)),
}


def _args(inputs, form, names):
    data = inputs[form]
    out = []
    for name in names:
        if name == "categories" and form != "dict":
            name = "recs"  # the table's category_id column
        out.append(data[name])
    return out


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metric_matches_jax(metric, mode, form, inputs):
    kwargs, names = METRICS[metric]
    args = _args(inputs, form, names)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jm.MetricDuplicatesWarning)
        want = getattr(jm, metric)(KS, mode=_mode(jm, mode), **kwargs)(*[_jax_side(a) for a in args])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = getattr(pm, metric)(KS, mode=_mode(pm, mode), **kwargs)(*args)
    _assert_same(got, want)
    if metric != "CategoricalDiversity":  # its call never checks duplicates
        assert any(issubclass(w.category, pm.MetricDuplicatesWarning) for w in caught)


@pytest.mark.parametrize("form", FORMS)
def test_coverage_matches_jax(form, inputs):
    recs, train = _args(inputs, form, ("recs", "train"))
    want = jm.Coverage(KS)(_jax_side(recs), _jax_side(train))
    _assert_same(pm.Coverage(KS)(recs, train), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("form", ("pandas", "table"))
@pytest.mark.parametrize("activation", [None, "sigmoid", "softmax"])
def test_ncis_precision_matches_jax(activation, form, mode, inputs):
    data = dict(inputs[form])
    # a NaN score makes its user's weights NaN in both packages: fill them
    scores = np.nan_to_num(np.asarray(data["recs"]["rating"], dtype=np.float64), nan=0.25)
    data["recs"] = data["recs"].assign(rating=scores)
    jax_metric = jm.NCISPrecision(
        KS, _jax_side(data["prev"]), threshold=4.0, activation=activation, mode=_mode(jm, mode)
    )
    port_metric = pm.NCISPrecision(KS, data["prev"], threshold=4.0, activation=activation, mode=_mode(pm, mode))
    want = jax_metric(_jax_side(data["recs"]), _jax_side(data["gt"]))
    _assert_same(port_metric(data["recs"], data["gt"]), want)


def test_ncis_refuses_unscored_dicts(inputs):
    metric = pm.NCISPrecision(KS, inputs["table"]["prev"])
    with pytest.raises(TypeError, match="scored recommendations as a DataFrame"):
        metric(inputs["dict"]["recs"], inputs["dict"]["gt"])


def _same_items(got, want):
    """Item lists equal position by position, a missing item equal to a
    missing one (NaN is not equal to itself)."""
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        a_missing = a is None or (isinstance(a, float) and a != a)
        b_missing = b is None or (isinstance(b, float) and b != b)
        if a_missing != b_missing or (not a_missing and (a != b or type(a) is not type(b))):
            return False
    return True


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("which", ["recs", "gt"])
def test_order_within_and_across_users_matches_jax(which, form, inputs):
    """``_recs_to_dict`` / ``_gt_to_dict``: the users in the same order, each
    user's items in the same order (ties in rating and item, NaN ratings last)."""
    value = inputs[form][which]
    convert = "_recs_to_dict" if which == "recs" else "_gt_to_dict"
    want = getattr(jm.Recall(5), convert)(_jax_side(value))
    got = getattr(pm.Recall(5), convert)(value)
    assert list(got) == list(want)
    assert all(_same_items(got[q], want[q]) for q in want)


def test_the_order_pins_ties_and_missing_ratings():
    """Rating then item, both descending, stable; NaN ratings and ``None``
    items last within their key; users in ascending order."""
    recs = ColumnTable({
        "query_id": np.array([2, 1, 1, 1, 1, 2, 2, 2]),
        "item_id": np.array([5, 3, 3, None, 1, 5, 7, 7], dtype=object),
        "rating": np.array([0.5, np.nan, 0.2, 0.2, 0.2, 0.5, np.nan, 0.5]),
    })
    got = pm.Recall(5)._recs_to_dict(recs)
    assert list(got) == [1, 2]
    assert got[1] == [3, 1, None, 3] and got[2] == [7, 5, 5, 7]
    assert got == jm.Recall(5)._recs_to_dict(pd.DataFrame(recs.to_numpy()))


def test_missing_items_match_each_other_as_pandas_merges_them():
    recs = {1: [None, 3, 3], 2: [float("nan"), 4]}
    truth = {1: [float("nan")], 2: [4, None]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in ("MAP", "Precision", "Recall", "NDCG"):
            _assert_same(getattr(pm, name)(3)(recs, truth), getattr(jm, name)(3)(recs, truth))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bases", ["single", "named"])
def test_offline_metrics_match_jax(bases, form, inputs):
    data = inputs[form]
    metrics = {
        module: [
            module.HitRate(KS), module.Precision(KS), module.Recall(KS), module.MAP(KS), module.MRR(KS),
            module.NDCG(KS), module.RocAuc(KS), module.Novelty(KS), module.Surprisal(KS), module.Coverage(KS),
            module.Unexpectedness(KS), module.CategoricalDiversity(KS),
        ]
        for module in (jm, pm)
    }
    recs = data["recs"]
    if form == "dict":  # the dict form has no category column: drop that metric
        metrics = {module: ms[:-1] for module, ms in metrics.items()}
    base = data["base_a"] if bases == "single" else {"a": data["base_a"], "b": data["base_b"]}
    jax_base = _jax_side(base) if bases == "single" else {k: _jax_side(v) for k, v in base.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jm.OfflineMetrics(metrics[jm])(
            _jax_side(recs), _jax_side(data["gt"]), train=_jax_side(data["train"]),
            base_recommendations=jax_base,
        )
        got = pm.OfflineMetrics(metrics[pm])(recs, data["gt"], train=data["train"], base_recommendations=base)
    _assert_same(got, want)
    unexpected = [key for key in got if key.startswith("Unexpectedness")]
    if bases == "single":
        assert unexpected == [f"Unexpectedness@{k}" for k in KS]
    else:
        assert unexpected == [f"Unexpectedness_{name}@{k}" for name in ("a", "b") for k in KS]


def test_offline_metrics_refuse_missing_arguments(inputs):
    data = inputs["table"]
    with pytest.raises(ValueError, match="Novelty requires `train`"):
        pm.OfflineMetrics([pm.Novelty(KS)])(data["recs"], data["gt"])
    with pytest.raises(ValueError, match="Unexpectedness requires `base_recommendations`"):
        pm.OfflineMetrics([pm.Unexpectedness(KS)])(data["recs"], data["gt"], train=data["train"])


@pytest.mark.parametrize("form", ("pandas", "table"))
def test_experiment_matches_jax(form, inputs):
    data = inputs[form]
    experiments = {}
    for module in (jm, pm):
        side = _jax_side if module is jm else (lambda v: v)
        experiment = module.Experiment(
            [module.Recall(KS), module.NDCG(KS), module.Coverage(KS), module.Unexpectedness(KS),
             module.CategoricalDiversity(KS), module.NCISPrecision(KS, side(data["prev"]))],
            side(data["gt"]), train=side(data["train"]),
            base_recommendations={"a": side(data["base_a"]), "b": side(data["base_b"])},
        )
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name, recs in (("model", "recs"), ("shifted", "base_b"), ("model", "base_a")):
                value = data[recs]
                if recs != "recs":  # give the base models a category column
                    value = value.assign(category_id=np.asarray(data["recs"]["category_id"]))
                experiment.add_result(name, side(value))
        experiments[module] = experiment
    want, got = experiments[jm].results, experiments[pm].results
    # a name added again replaces its row, which moves to the end
    assert list(want.index) == ["shifted", "model"] == list(got["name"])
    assert got.columns == ["name", *want.columns]
    for column in want.columns:
        np.testing.assert_allclose(got[column], want[column].to_numpy(), rtol=0, atol=TOL, err_msg=column)
    want_cmp, got_cmp = experiments[jm].compare("shifted"), experiments[pm].compare("shifted")
    assert list(got_cmp["name"]) == list(want_cmp.index)
    for column in want_cmp.columns:
        np.testing.assert_allclose(got_cmp[column], want_cmp[column].to_numpy(), rtol=0, atol=TOL, err_msg=column)
    with pytest.raises(KeyError, match="No results stored for baseline 'other'"):
        experiments[pm].compare("other")


def test_metrics_to_df_matches_jax():
    """In k order the JAX frame and the port's table hold the same values.
    Keys in another order (``get_metrics`` sorts them as strings, so @10
    comes before @5) are placed by their k in the port; the JAX frame keeps
    the columns in first-seen order under sorted labels there (ROADMAP.md,
    "Not the port's")."""
    flat = {"recall@1": 0.1, "recall@5": 0.15, "recall@10": 0.2, "map@1": 0.01, "map@5": 0.05, "coverage@10": 0.5}
    want = jm.metrics_to_df(flat)
    got = pm.metrics_to_df(flat)
    assert list(got["metric"]) == list(want.index)
    assert got.columns == ["metric", *want.columns]
    for column in want.columns:
        np.testing.assert_array_equal(got[column], want[column].to_numpy())
    shuffled = pm.metrics_to_df(dict(sorted(flat.items())))
    for column in got.columns:
        np.testing.assert_array_equal(shuffled[column], got[column])


def _builder_batches():
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(4):
        predictions = np.stack([rng.permutation(30)[:10] for _ in range(6)]).astype(np.int32)
        truth = np.full((6, 3), -1, np.int32)
        truth[:, 0] = rng.integers(0, 30, 6)
        truth[:2, 1] = rng.integers(0, 30, 2)
        train = np.where(rng.random((6, 5)) < 0.7, rng.integers(0, 30, (6, 5)), -1).astype(np.int32)
        valid = np.array([True] * 5 + [bool(rng.integers(0, 2))])
        batches.append((predictions, truth, train, valid))
    return batches


BUILDER = dict(metrics=("recall", "precision", "ndcg", "map", "mrr", "hitrate", "novelty", "coverage"), top_k=(1, 5, 10), item_count=30)


def _port_builder(batches):
    builder = pm.MetricsBuilder(**BUILDER)
    for predictions, truth, train, valid in batches:
        builder.add_prediction(predictions, truth, train, valid)
    return builder


def test_load_state_takes_the_port_and_the_jax_state():
    batches = _builder_batches()
    whole = _port_builder(batches)
    want = whole.get_metrics()
    restored = pm.MetricsBuilder(**BUILDER)
    restored.load_state(whole.state())
    assert restored.get_metrics() == want
    jax_builder = JaxMetricsBuilder(**BUILDER)
    for predictions, truth, train, valid in batches:
        jax_builder.add_prediction(predictions, truth, train, valid)
    from_jax = pm.MetricsBuilder(**BUILDER)
    from_jax.load_state(jax.tree.map(np.asarray, jax_builder.state()))
    assert from_jax.get_metrics() == jax_builder.get_metrics()
    for key, value in want.items():
        assert abs(value - jax_builder.get_metrics()[key]) <= 1e-6, key


def test_load_state_of_summed_halves_counts_coverage_once():
    batches = _builder_batches()
    halves = [_port_builder(batches[:2]).state(), _port_builder(batches[2:]).state()]
    summed = {
        "sums": {key: halves[0]["sums"][key] + halves[1]["sums"][key] for key in halves[0]["sums"]},
        "count": halves[0]["count"] + halves[1]["count"],
        "coverage": {key: halves[0]["coverage"][key].int() + halves[1]["coverage"][key].int() for key in halves[0]["coverage"]},
    }
    assert max(int(v.max()) for v in summed["coverage"].values()) == 2  # an item seen by both halves
    merged = pm.MetricsBuilder(**BUILDER)
    merged.load_state(summed)
    want = _port_builder(batches).get_metrics()
    got = merged.get_metrics()
    assert got.keys() == want.keys()
    for key in want:
        # f32 partial sums added in another order
        assert abs(got[key] - want[key]) <= 1e-6 * max(1.0, abs(want[key])), key
        if key.startswith("coverage"):
            assert got[key] == want[key]
    assert isinstance(merged.state()["count"], torch.Tensor)
