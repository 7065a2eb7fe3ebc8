"""The port's TwoTower against the JAX package's, on weights carried across.

The port's ``TwoTower`` (with an item schema of one categorical feature and,
where named, a context merger) draws its weights from a seed;
``convert.torch_to_flax`` carries them into the JAX ``TwoTower``; the same
numpy inputs go through both. Query hidden states, ``forward_inference`` with
and without candidates, ``get_query_embeddings`` and ``encode_items`` (the
catalog and candidate rows, with the item features fused) within atol 1e-5 /
rtol 1e-5 (f32, summation orders differ). Training: three ``train_step``s of
each package with ``CESampled`` on the same JAX-made in-batch batches, the
catalog's feature arrays supplied by the batch to ``get_logits``; losses
within rtol 1e-4, parameters within atol 1e-5 (``test_torch_train.py``'s
limits). The deduplicated in-batch scoring against the literal one: loss and
gradients within rtol 1e-5 / atol 1e-6. ``validate``/``predict_top_k`` through
the catalog cache, ``FeaturesReader`` and the serving programs. Mirrors
``tests/nn/test_twotower.py``.
"""

import flax.linen as fnn
import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn.loss import CESampled as JaxCESampled
from replay_tpu.nn.sequential.twotower import FeaturesReader as JaxFeaturesReader
from replay_tpu.nn.sequential.twotower import TwoTower as JaxTwoTower
from replay_tpu.nn.transform import Compose as JaxCompose
from replay_tpu.nn.transform import make_default_twotower_transforms as jax_twotower_transforms
from replay_tpu_torch.convert import flax_to_torch, torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.compiled import CompiledInference
from replay_tpu_torch.nn.layers import Dense
from replay_tpu_torch.nn.loss import CESampled
from replay_tpu_torch.nn.sequential import FeaturesReader, TwoTower
from replay_tpu_torch.nn.train import Trainer
from replay_tpu_torch.nn.transform import Compose, make_default_twotower_transforms

NUM_ITEMS, DIM, BLOCKS, HEADS, SEQ_LEN, BATCH = 50, 16, 2, 2, 8, 4
WIDTH = dict(embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS, max_sequence_length=SEQ_LEN)
ATOL = RTOL = 1e-5
STEPS = 3
FEATURES = {"category": (np.arange(NUM_ITEMS) % 3).astype(np.int32)}


def item_feature(module, dim=DIM):
    return module.TensorFeatureInfo("category", module.FeatureType.CATEGORICAL, cardinality=3, embedding_dim=dim)


class _Types:
    def __init__(self, info, feature_type, hint, schema):
        self.TensorFeatureInfo, self.FeatureType, self.FeatureHint, self.TensorSchema = info, feature_type, hint, schema


JAX = _Types(TensorFeatureInfo, FeatureType, FeatureHint, TensorSchema)
PORT = _Types(PortTensorFeatureInfo, PortFeatureType, PortFeatureHint, PortTensorSchema)


def schemas(module):
    query = module.TensorSchema(
        module.TensorFeatureInfo(
            "item_id", module.FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=module.FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    return query, module.TensorSchema(item_feature(module))


class JaxGateMerger(fnn.Module):
    """Gates the hidden state by a projection of the item id's parity."""

    @fnn.compact
    def __call__(self, hidden, feature_tensors):
        signal = (feature_tensors["item_id"] % 2).astype(hidden.dtype)[..., None]
        return hidden * jax.nn.sigmoid(fnn.Dense(hidden.shape[-1], name="gate")(signal))


class GateMerger(torch.nn.Module):
    """The port's counterpart, with the flax submodule name."""

    def __init__(self):
        super().__init__()
        self.gate = Dense(1, DIM)
        with torch.no_grad():
            self.gate.weight.copy_(torch.linspace(-1.0, 1.0, DIM)[:, None])
            self.gate.bias.fill_(0.25)

    def forward(self, hidden, feature_tensors):
        signal = (feature_tensors["item_id"] % 2).to(hidden.dtype)[..., None]
        return hidden * torch.sigmoid(self.gate(signal))


def port_model(merger=False, use_flash=True, seed=0):
    query, items = schemas(PORT)
    return TwoTower(
        query, item_schema=items, context_merger=GateMerger() if merger else None, use_flash=use_flash,
        device="cpu", generator=torch.Generator().manual_seed(seed), **WIDTH,
    )


def jax_model(merger=False, use_flash=True):
    query, items = schemas(JAX)
    return JaxTwoTower(
        schema=query, item_schema=items, context_merger=JaxGateMerger() if merger else None, use_flash=use_flash,
        **WIDTH,
    )


def windows(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([SEQ_LEN, 5, 1, 0])
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
    ids = np.where(mask, rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN)), NUM_ITEMS).astype(np.int32)
    return ids, mask


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_convert_round_trip_is_exact():
    model = port_model(merger=True)
    tree = torch_to_flax(model.state_dict())
    assert {"embedder", "aggregator", "encoder", "final_norm", "item_feature_embedder", "item_encoder",
            "context_merger"} == set(tree)
    assert set(tree["item_encoder"]) == {"norm_0", "swiglu_0", "final_norm", "final_proj"}
    assert set(tree["item_encoder"]["swiglu_0"]) == {"gate", "value", "out"}
    assert set(tree["item_encoder"]["swiglu_0"]["gate"]) == {"kernel"}  # bias-free, as flax use_bias=False
    state = flax_to_torch({"params": tree})
    back = torch_to_flax(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)
    assert list(state) == list(model.state_dict())


def test_towers_match():
    """On the K4 route, which the card runs (the unfused encoder is SASRec's,
    held in ``test_torch_sasrec.py``)."""
    port = port_model(merger=True)
    params = torch_to_flax(port.state_dict())
    model = jax_model(merger=True)
    variables = {"params": params}
    ids, mask = windows(1)
    rng = np.random.default_rng(2)
    flat = rng.integers(0, NUM_ITEMS, 7).astype(np.int32)
    per_row = rng.integers(0, NUM_ITEMS, (BATCH, 5)).astype(np.int32)
    tensors, pmask = {"item_id": torch.tensor(ids)}, torch.tensor(mask)
    features = {name: torch.tensor(value) for name, value in FEATURES.items()}


    @jax.jit
    def jax_outputs(variables):  # one compile for every output
        return (
            model.apply(variables, {"item_id": ids}, mask),
            [model.apply(variables, {"item_id": ids}, mask, c, FEATURES, method=JaxTwoTower.forward_inference)
             for c in (None, per_row)],
            [model.apply(variables, c, FEATURES, method=JaxTwoTower.encode_items) for c in (None, flat)],
        )

    hidden, inferred, encoded = jax_outputs(variables)
    with torch.no_grad():
        close(port(tensors, pmask), hidden)
        close(port.get_query_embeddings(tensors, pmask), np.asarray(hidden)[:, -1, :])
        for candidates, want in zip((None, per_row), inferred):
            got = port.forward_inference(tensors, pmask, None if candidates is None else torch.tensor(candidates), features)
            close(got, want)
        for candidates, want in zip((None, flat), encoded):
            close(port.encode_items(None if candidates is None else torch.tensor(candidates), features), want)
        # the merger and the item features both change the outputs
        assert not torch.allclose(port(tensors, pmask), port_model(merger=False)(tensors, pmask))
        assert not torch.allclose(port.encode_items(None, features), port.encode_items(None, None))


def test_deduplicated_pool_scoring_equals_the_literal_form():
    """A shared pool ([N]) and per-row pools ([B, N]), broadcast to [B, L, N]
    by CESampled: encoding each pool once gives the literal loss and gradients."""
    port = port_model()
    ids, mask = windows(3)
    rng = np.random.default_rng(4)
    labels = torch.tensor(rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN, 1)).astype(np.int32))
    target = torch.tensor(mask[..., None])
    pooled = []
    original = port._pool_logits
    port._pool_logits = lambda *args: pooled.append(args[1].shape) or original(*args)
    for pool in (rng.integers(0, NUM_ITEMS, BATCH), rng.integers(0, NUM_ITEMS, (BATCH, 6))):
        results = []
        for dedup in (True, False):
            port.dedup_candidates = dedup
            port.zero_grad()
            loss = CESampled()
            loss.logits_callback = lambda h, c: port.get_logits(h, c, FEATURES)
            hidden = port({"item_id": torch.tensor(ids)}, torch.tensor(mask))
            value = loss(hidden, {}, labels, torch.tensor(pool.astype(np.int32)), torch.tensor(mask), target)
            value.backward()
            results.append((value.item(), [p.grad.clone() for p in port.parameters() if p.grad is not None]))
        (got, got_grads), (want, want_grads) = results
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert len(got_grads) == len(want_grads)
        for a, b in zip(got_grads, want_grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    # the deduplicated form ran once a pool, on the negatives; never on the positives
    assert pooled == [(BATCH, SEQ_LEN, BATCH), (BATCH, SEQ_LEN, 6)]


# --------------------------------------------------------------------------- #
# training against the JAX trainer
# --------------------------------------------------------------------------- #
def in_batch_batches():
    """The JAX pipeline's in-batch batches, the catalog features added, as numpy."""
    pipeline = JaxCompose(jax_twotower_transforms(schemas(JAX)[0])["train"])
    batches = []
    for seed in range(STEPS):
        rng = np.random.default_rng(20 + seed)
        items = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN + 1)).astype(np.int32)
        mask = np.ones_like(items, bool)
        mask[2, :3] = False
        items[~mask] = NUM_ITEMS
        batch = jax.tree.map(np.asarray, pipeline({"item_id": items, "item_id_mask": mask}))
        batches.append({**batch, "item_feature_tensors": FEATURES})
    return batches


@pytest.fixture(scope="module")
def jax_run():
    params = torch_to_flax(port_model().state_dict())
    trainer = JaxTrainer(model=jax_model(), loss=JaxCESampled())
    batches = in_batch_batches()
    state = trainer.init_state(batches[0], params=params)
    losses = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return params, batches, losses, jax.tree.map(np.asarray, state.params)


SHIFT_INVARIANT = ("['item_encoder']['final_norm']['bias']", "['item_encoder']['final_proj']['bias']")


def test_train_steps_match_jax(jax_run):
    params, batches, jax_losses, jax_params = jax_run
    assert batches[0]["negative_labels"].shape == (BATCH,)
    trainer = Trainer(port_model(), CESampled(), device="cpu")
    assert trainer._logits_extra_params == ["item_feature_tensors"]
    state = trainer.init_state(batches[0], params=flax_to_torch(params))
    losses = [float(trainer.train_step(state, batch)[1]) for batch in batches]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    got = torch_to_flax({name: value.detach() for name, value in state.params.items()})
    for path, want in jax.tree_util.tree_leaves_with_path(jax_params):
        node, start = got, params
        for key in path:
            node, start = node[key.key], start[key.key]
        name = jax.tree_util.keystr(path)
        if "['key']['bias']" in name or name in SHIFT_INVARIANT:
            # each adds one constant to every score of a query (a bias on the
            # keys, or on every item's encoding), to which the softmax is
            # blind: a zero gradient up to rounding noise, which Adam scales
            # to ±lr a step on either side
            assert np.abs(node - start).max() <= STEPS * 1e-3 * 1.01, name
            continue
        np.testing.assert_allclose(node, want, atol=1e-5, err_msg=name)
    # the item features reached the loss: without them the same step differs
    bare = Trainer(port_model(), CESampled(), device="cpu")
    bare_state = bare.init_state(batches[0], params=flax_to_torch(params))
    _, bare_loss = bare.train_step(bare_state, {k: v for k, v in batches[0].items() if k != "item_feature_tensors"})
    assert abs(float(bare_loss) - losses[0]) > 1e-6
    # the chunked path stacks the [B] negative pool and equals the per-step one
    chunked = Trainer(port_model(), CESampled(), device="cpu")
    chunk_state = chunked.init_state(batches[0], params=flax_to_torch(params))
    _, chunk_losses = chunked.train_steps(chunk_state, batches)
    np.testing.assert_array_equal(chunk_losses, np.asarray(losses, np.float32))
    assert torch.equal(chunk_state.flat_params, state.flat_params)


def test_the_port_template_trains():
    pipeline = Compose(make_default_twotower_transforms(schemas(PORT)[0])["train"])
    trainer = Trainer(port_model(), CESampled(), device="cpu")
    rng = np.random.default_rng(5)
    raw = {"item_id": rng.integers(0, NUM_ITEMS, (8, SEQ_LEN + 1)).astype(np.int32),
           "item_id_mask": np.ones((8, SEQ_LEN + 1), bool)}
    batch = {**pipeline(raw), "item_feature_tensors": FEATURES}
    state, losses = trainer.init_state(batch), []
    for _ in range(5):
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_evaluation_encodes_the_catalog_once(jax_run):
    trainer = Trainer(port_model(), CESampled(), device="cpu")
    state = trainer.init_state(jax_run[1][0], params=flax_to_torch(jax_run[0]))
    ids, mask = windows(6)
    batch = {
        "feature_tensors": {"item_id": ids}, "padding_mask": mask, "item_feature_tensors": FEATURES,
        "query_id": np.arange(BATCH), "ground_truth": np.stack([ids[:, -1], np.full(BATCH, -1)], 1),
    }
    calls = {"n": 0}
    original = trainer.model.encode_items

    def counting(*args, **kwargs):
        calls["n"] += 1
        return original(*args, **kwargs)

    trainer.model.encode_items = counting
    _, items, scores = trainer.predict_top_k(state, [dict(batch)] * 3, k=4)
    assert calls["n"] == 1  # one catalog encode for three batches
    per_batch = trainer.predict_logits(state, dict(batch)).numpy()
    order = np.argsort(-per_batch, axis=1, kind="stable")[:, :4]
    real = mask.any(axis=1)
    np.testing.assert_array_equal(items[:BATCH][real], order[real])
    # the all-padding row scores every item 0: top_k orders those ties by id,
    # as jax.lax.top_k does
    assert (~real).any() and (per_batch[~real] == 0).all()
    np.testing.assert_array_equal(items[:BATCH], np.asarray(jax.lax.top_k(jnp.asarray(per_batch), 4)[1]))
    np.testing.assert_allclose(scores[:BATCH], np.take_along_axis(per_batch, order, 1), rtol=1e-5, atol=1e-6)
    calls["n"] = 0
    metrics = trainer.validate(state, [dict(batch), dict(batch)], top_k=(1, 4))
    assert calls["n"] == 1 and 0.0 <= metrics["recall@4"] <= 1.0
    trainer.model.encode_items = original


def test_serving_programs_keep_the_jax_definitions():
    """For TwoTower the last-position forward is forward_inference's own
    query, so the ``"logits"`` and ``"both"`` programs agree (the serialized
    form is held in ``test_torch_bert4rec.py`` and on the card)."""
    model = port_model(merger=True)
    ids, mask = windows(7)
    logits_program = CompiledInference.compile(model, model.state_dict(), SEQ_LEN, batch_size=BATCH, device="cpu")
    both = CompiledInference.compile(model, model.state_dict(), SEQ_LEN, batch_size=BATCH, outputs="both", device="cpu")
    with torch.no_grad():
        want = model.forward_inference({"item_id": torch.tensor(ids)}, torch.tensor(mask))
        hidden = model({"item_id": torch.tensor(ids)}, torch.tensor(mask))[:, -1, :]
    got = logits_program(ids, mask)
    assert torch.equal(got, want)
    logits, last = both(ids, mask)
    assert torch.equal(last, hidden) and torch.allclose(logits, want, rtol=1e-6, atol=1e-6)


def test_features_reader_matches_jax():
    schema_jax, schema_port = TensorSchema(item_feature(JAX, 8)), PortTensorSchema(item_feature(PORT, 8))
    columns = {"item_id": np.array([2, 0, 1]), "category": np.array([2, 0, 1])}
    got = FeaturesReader(schema_port, num_items=4).read(columns)
    want = JaxFeaturesReader(schema_jax, num_items=4).read(pd.DataFrame(columns))
    np.testing.assert_array_equal(got["category"], want["category"])
    assert got["category"].dtype == want["category"].dtype
    np.testing.assert_array_equal(got["category"], [0, 1, 2, 0])  # id 3 missing -> 0
    # a data frame reads the same, without the port importing pandas itself
    np.testing.assert_array_equal(FeaturesReader(schema_port, num_items=4).read(pd.DataFrame(columns))["category"],
                                  got["category"])
    with pytest.raises(ValueError, match="Duplicate"):
        FeaturesReader(schema_port).read({"item_id": np.array([0, 0]), "category": np.array([1, 2])})
    with pytest.raises(ValueError, match="encoded"):
        FeaturesReader(schema_port, num_items=2).read({"item_id": np.array([0, 5]), "category": np.array([1, 2])})
    with pytest.raises(ValueError, match="not found"):
        FeaturesReader(schema_port).read({"item": np.array([0])})
