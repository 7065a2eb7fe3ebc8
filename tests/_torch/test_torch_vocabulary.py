"""The port's vocabulary surgery against the JAX package's ``nn/vocabulary.py``.

Both packages start from one SASRec (or BERT4Rec) param tree, converted with
``flax_to_torch``, and one Adam state: optax's, with random ``mu`` and ``nu``
and ``count`` 3, carried into the port's flat moment buffers by
``convert.opt_state_from_jax``. Every function of the module runs on both;
params are compared bitwise leaf by leaf, the resized moments bitwise row by
row (trained rows kept, cold rows zero, the padding row moved last), the
schemas field by field. The guards (params and schema out of sync, moments
out of sync, ``fit``'s refusal of stale moments) raise as the JAX ones do.
``Trainer.finetune`` is held to the JAX trainer's at dropout 0 with mean
cold rows on both sides (the xavier rows differ by generator, so they are
checked by shape and std): parameters within atol 1e-5 after the fit's Adam
steps (f32 gradients in another order, divided by their running RMS), the
losses within rtol 1e-4; the attention key biases, whose gradient is
rounding noise that Adam scales to a full step, within 2 x steps x lr. A
grown generation published to a service built on the model at the old size
serves ``predict_top_k``'s top-10 over the grown catalog.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from replay_tpu.data import FeatureHint as JaxFeatureHint
from replay_tpu.data import FeatureType as JaxFeatureType
from replay_tpu.data.nn import TensorFeatureInfo as JaxTensorFeatureInfo
from replay_tpu.data.nn import TensorSchema as JaxTensorSchema
from replay_tpu.nn import OptimizerFactory as JaxOptimizerFactory
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn import vocabulary as jax_vocabulary
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.sequential.bert4rec import Bert4Rec as JaxBert4Rec
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu_torch.convert import flax_to_torch, opt_state_from_jax
from replay_tpu_torch.data import FeatureHint, FeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu_torch.nn import vocabulary
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.sequential import Bert4Rec
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
from replay_tpu_torch.serve import ScoringService
from replay_tpu_torch.serve.request import make_window, top_k_cut

NUM_ITEMS, SEQ_LEN, BATCH, DIM = 8, 5, 4, 8
TABLE = "body.embedder.embedding_item_id.table.weight"


def schemas(cardinality=NUM_ITEMS):
    def one(info, schema, hint, kind):
        return schema(info("item_id", kind.CATEGORICAL, is_seq=True, feature_hint=hint.ITEM_ID,
                           cardinality=cardinality, embedding_dim=DIM))

    return (one(JaxTensorFeatureInfo, JaxTensorSchema, JaxFeatureHint, JaxFeatureType),
            one(TensorFeatureInfo, TensorSchema, FeatureHint, FeatureType))


def make_batch(num_items, seed):
    rng = np.random.default_rng(seed)
    items = rng.integers(0, num_items, (BATCH, SEQ_LEN + 1)).astype(np.int32)
    mask = np.ones((BATCH, SEQ_LEN), bool)
    return {
        "feature_tensors": {"item_id": items[:, :-1]},
        "padding_mask": mask,
        "positive_labels": items[:, 1:, None],
        "target_padding_mask": mask[:, :, None],
    }


def models(kind, jax_schema, port_schema):
    if kind == "sasrec":
        jax_model = JaxSasRec(schema=jax_schema, embedding_dim=DIM, num_blocks=1, max_sequence_length=SEQ_LEN)
        port_model = SasRec(port_schema, embedding_dim=DIM, num_blocks=1, max_sequence_length=SEQ_LEN, device="cpu")
    else:
        jax_model = JaxBert4Rec(schema=jax_schema, embedding_dim=DIM, num_blocks=1, num_heads=2,
                                max_sequence_length=SEQ_LEN)
        port_model = Bert4Rec(port_schema, embedding_dim=DIM, num_blocks=1, num_heads=2,
                              max_sequence_length=SEQ_LEN, device="cpu")
    return jax_model, port_model


@functools.lru_cache(maxsize=None)
def jax_params(kind, seed=0):
    """The JAX model's initial params, numpy leaves (built once per model)."""
    jax_model, _ = models(kind, *schemas())
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(seed), {"item_id": np.zeros((2, SEQ_LEN), np.int32)},
                                     np.ones((2, SEQ_LEN), bool))["params"]
    return jax.tree.map(np.asarray, params)


def setup(kind, seed=0):
    """Both packages at one param tree and one Adam state (random moments)."""
    jax_schema, port_schema = schemas()
    _, port_model = models(kind, jax_schema, port_schema)
    params = jax.tree.map(np.copy, jax_params(kind, seed))
    rng = np.random.default_rng(seed)
    opt = JaxOptimizerFactory(learning_rate=1e-2).create().init(params)
    opt = jax.tree.map(lambda x: np.full_like(np.asarray(x), 3) if np.ndim(x) == 0
                       else rng.standard_normal(np.shape(x)).astype(np.float32), opt)
    trainer = Trainer(port_model, CE(), optimizer=OptimizerFactory(learning_rate=1e-2), device="cpu")
    state = trainer.init_state(make_batch(NUM_ITEMS, 0), params=flax_to_torch(params))
    state.opt_state = opt_state_from_jax(opt, state.opt_state, list(state.params))
    return jax_schema, port_schema, params, opt, trainer, state


def assert_params_equal(port, jax_params):
    want = flax_to_torch(jax_params)
    assert list(want) and set(port) == set(want)
    for name, value in port.items():
        assert torch.equal(value.detach(), want[name]), name


def table_moments(opt_state, params):
    """Each moment buffer's item-table rows, ``[rows, E]``."""
    offset = 0
    for name, value in params.items():
        if name == TABLE:
            break
        offset += value.numel()
    rows = params[TABLE].shape[0]
    return [link[key][offset : offset + rows * DIM].view(rows, DIM) for link in opt_state for key in ("mu", "nu")
            if key in link]


# (new cardinality, init tensor rows or None): mean growth, appended rows, a
# full replacement, a shrink
RESIZES = {"grow_mean": (NUM_ITEMS + 3, None), "grow_tensor": (NUM_ITEMS + 2, 2),
           "replace": (NUM_ITEMS + 1, NUM_ITEMS + 1), "shrink": (NUM_ITEMS - 3, None)}


@pytest.mark.parametrize("case", sorted(RESIZES))
@pytest.mark.parametrize("kind", ["sasrec", "bert4rec"])
def test_resize_item_embeddings_with_moments_matches_jax(kind, case):
    jax_schema, port_schema, params, opt, trainer, state = setup(kind)
    new, rows = RESIZES[case]
    init = None if rows is None else np.random.default_rng(1).standard_normal((rows, DIM)).astype(np.float32)
    jax_params, jax_opt = jax_vocabulary.resize_item_embeddings(params, jax_schema, new, init, opt_state=opt)
    before = [m.clone() for m in table_moments(state.opt_state, state.params)]
    port_params, port_opt = vocabulary.resize_item_embeddings(
        dict(state.params), port_schema, new, None if init is None else torch.tensor(init), opt_state=state.opt_state
    )
    assert_params_equal(port_params, jax_params)
    assert port_schema["item_id"].cardinality == jax_schema["item_id"].cardinality == new
    assert port_schema["item_id"].padding_value == jax_schema["item_id"].padding_value == new
    # the moments: the JAX result carried over equals the port's, bit for bit
    carried = opt_state_from_jax(jax_opt, port_opt, list(port_params))
    for link, want in zip(port_opt, carried):
        assert set(link) == set(want) and all(torch.equal(link[k], want[k]) for k in link)
    # and row by row: trained rows kept, cold rows zero, the padding row last
    kept = min(new, NUM_ITEMS)
    for old, grown in zip(before, table_moments(port_opt, port_params)):
        assert grown.shape == (new + 1, DIM)
        assert torch.equal(grown[:kept], old[:kept]) and torch.equal(grown[-1], old[-1])
        assert not grown[kept:-1].any()


@pytest.mark.parametrize("kind", ["sasrec", "bert4rec"])
def test_append_set_get_and_xavier_match_jax(kind):
    jax_schema, port_schema, params, _, _, state = setup(kind)
    port = dict(state.params)
    rows = np.ones((2, DIM), np.float32)
    jax_params = jax_vocabulary.append_item_embeddings(params, jax_schema, rows)
    port = vocabulary.append_item_embeddings(port, port_schema, rows)
    assert_params_equal(port, jax_params)
    replacement = np.full((NUM_ITEMS + 5, DIM), 2.0, np.float32)
    jax_params = jax_vocabulary.set_item_embeddings_by_tensor(jax_params, jax_schema, replacement)
    port = vocabulary.set_item_embeddings_by_tensor(port, port_schema, torch.tensor(replacement))
    assert_params_equal(port, jax_params)
    assert torch.equal(vocabulary.get_item_embeddings(port, port_schema),
                       torch.tensor(jax_vocabulary.get_item_embeddings(jax_params, jax_schema)))
    assert vocabulary.set_item_embeddings is vocabulary.set_item_embeddings_by_tensor
    # xavier rows: the reference's std, from an explicit generator
    with pytest.raises(ValueError, match="greater"):
        vocabulary.set_item_embeddings_by_size(port, port_schema, NUM_ITEMS + 5)
    grown = vocabulary.set_item_embeddings_by_size(port, port_schema, 400, rng=torch.Generator().manual_seed(7))
    fresh = vocabulary.get_item_embeddings(grown, port_schema)[NUM_ITEMS + 5:]
    assert fresh.shape == (400 - NUM_ITEMS - 5, DIM)
    assert abs(float(fresh.std()) / np.sqrt(2.0 / (401 + DIM)) - 1) < 0.05
    again = vocabulary.set_item_embeddings_by_size(port, schemas(NUM_ITEMS + 5)[1], 400, rng=torch.Generator().manual_seed(7))
    assert torch.equal(again[TABLE], grown[TABLE])


def test_guards_raise_as_jax():
    jax_schema, port_schema, params, opt, trainer, state = setup("sasrec")
    layout = dict(state.params)
    grown = vocabulary.resize_item_embeddings(layout, port_schema, NUM_ITEMS + 2)
    jax_vocabulary.resize_item_embeddings(params, jax_schema, NUM_ITEMS + 2)
    # the moments left at the old size while the schema moved on
    for resize, args in ((jax_vocabulary.resize_optimizer_state, (opt, "item_id", NUM_ITEMS + 2, NUM_ITEMS + 4)),
                         (vocabulary.resize_optimizer_state,
                          (state.opt_state, "item_id", NUM_ITEMS + 2, NUM_ITEMS + 4, grown))):
        with pytest.raises(ValueError, match="out of sync"):
            resize(*args)
    # a resize applied twice to the same params
    for module, p, s in ((jax_vocabulary, params, jax_schema), (vocabulary, layout, port_schema)):
        with pytest.raises(ValueError, match="params and schema are out of sync"):
            module.resize_item_embeddings(p, s, NUM_ITEMS + 4)
    with pytest.raises(ValueError, match="accepts only a full"):
        vocabulary.resize_item_embeddings(grown, port_schema, NUM_ITEMS, np.zeros((2, DIM), np.float32))
    vocabulary.validate_optimizer_state(layout, state.opt_state, schemas()[1])  # in sync: no raise
    with pytest.raises(ValueError, match="embedding_item_id"):
        vocabulary.validate_optimizer_state(grown, state.opt_state, port_schema)
    assert vocabulary.resize_optimizer_state([{}], "item_id", NUM_ITEMS, NUM_ITEMS + 1, layout) == ([{}], 0)


def test_trainer_resize_vocabulary_carries_moments_and_fit_refuses_stale_ones():
    _, port_schema, _, _, trainer, state = setup("sasrec")
    old_opt = [{k: v.clone() for k, v in link.items()} for link in state.opt_state]
    before = [m.clone() for m in table_moments(state.opt_state, state.params)]
    init = torch.full((4, DIM), 0.5)
    grown = trainer.resize_vocabulary(state, NUM_ITEMS + 4, init_tensor=init)
    assert port_schema["item_id"].cardinality == NUM_ITEMS + 4
    assert grown.step == state.step and torch.equal(grown.rng, state.rng)
    table = grown.params[TABLE]
    assert table.shape == (NUM_ITEMS + 5, DIM) and torch.equal(table[NUM_ITEMS:-1], init)
    assert trainer.model.body.embedder.embedding_item_id.cardinality == NUM_ITEMS + 4
    for old, new in zip(before, table_moments(grown.opt_state, grown.params)):
        assert torch.equal(new[:NUM_ITEMS], old[:NUM_ITEMS]) and torch.equal(new[-1], old[-1])
        assert not new[NUM_ITEMS:-1].any()
    assert int(grown.opt_state[0]["count"]) == 3
    grown, loss = trainer.train_step(grown, make_batch(NUM_ITEMS + 4, 2))
    assert np.isfinite(float(loss))
    stale = dataclasses.replace(grown, opt_state=old_opt)
    with pytest.raises(ValueError, match="embedding_item_id"):
        trainer.fit([make_batch(NUM_ITEMS + 4, 3)], state=stale, log_every=0)
    # a fresh optimizer state instead of the carried one; xavier rows
    fresh = trainer.resize_vocabulary(grown, 300, carry_opt_state=False, init="xavier")
    assert int(fresh.opt_state[0]["count"]) == 0 and not fresh.opt_state[0]["mu"].any()
    rows = fresh.params[TABLE][NUM_ITEMS + 4 : -1]
    assert rows.shape == (300 - NUM_ITEMS - 4, DIM)
    assert abs(float(rows.std()) / np.sqrt(2.0 / (301 + DIM)) - 1) < 0.05
    with pytest.raises(ValueError, match="unknown init"):
        trainer.resize_vocabulary(fresh, 301, init="zeros")


def test_finetune_matches_jax_and_refuses_to_shrink():
    jax_schema, port_schema = schemas()
    jax_model, port_model = models("sasrec", jax_schema, port_schema)
    jax_trainer = JaxTrainer(model=jax_model, loss=JaxCE(), optimizer=JaxOptimizerFactory(learning_rate=1e-2))
    jax_state = jax_trainer.init_state(make_batch(NUM_ITEMS, 0))
    trainer = Trainer(port_model, CE(), optimizer=OptimizerFactory(learning_rate=1e-2), device="cpu")
    state = trainer.init_state(make_batch(NUM_ITEMS, 0), params=flax_to_torch(jax.tree.map(np.asarray, jax_state.params)))
    tail = [make_batch(NUM_ITEMS + 4, seed) for seed in (5, 6)]
    jax_state = jax_trainer.finetune(jax_state, tail, new_cardinality=NUM_ITEMS + 4, init="mean", log_every=0)
    state = trainer.finetune(state, tail, new_cardinality=NUM_ITEMS + 4, init="mean", log_every=0)
    assert port_schema["item_id"].cardinality == jax_schema["item_id"].cardinality == NUM_ITEMS + 4
    want = flax_to_torch(jax.tree.map(np.asarray, jax_state.params))
    for name, value in state.params.items():
        # attention key biases have a zero gradient up to rounding noise,
        # which Adam scales to the full step: bounded by steps x lr instead
        atol = 2 * len(tail) * 1e-2 if name.endswith("key.bias") else 1e-5
        np.testing.assert_allclose(value.detach().numpy(), want[name].numpy(), rtol=0, atol=atol, err_msg=name)
    np.testing.assert_allclose(trainer.history[-1]["train_loss"], jax_trainer.history[-1]["train_loss"], rtol=1e-4)
    with pytest.raises(ValueError, match="shrink"):
        trainer.finetune(state, tail, new_cardinality=NUM_ITEMS)


def test_a_grown_generation_publishes_through_the_shape_change_path():
    """A service built on the model at the old size takes the grown
    generation through ``publish_candidate``'s fresh engine and serves the
    top-10 of ``predict_top_k`` over the whole grown catalog."""
    _, _, _, _, trainer, state = setup("sasrec")
    served = SasRec(schemas()[1], embedding_dim=DIM, num_blocks=1, max_sequence_length=SEQ_LEN, device="cpu")
    service = ScoringService(
        served, {k: v.detach().clone() for k, v in state.params.items()}, length_buckets=(SEQ_LEN,),
        batch_buckets=(1, 2), device="cpu",
    ).start()
    try:
        rows = torch.tensor(np.random.default_rng(3).standard_normal((5, DIM)).astype(np.float32))
        grown = trainer.resize_vocabulary(state, NUM_ITEMS + 5, init_tensor=rows)
        generation = service.publish_candidate({k: v.detach().clone() for k, v in grown.params.items()}, label="grown")
        assert service.store.generation(generation).engine is not None  # a fresh engine
        service.promote(generation)
        history = [1, 3, NUM_ITEMS + 2, 5]
        response = service.score("u", history=history, timeout=60)
        assert response.scores.shape == (NUM_ITEMS + 5,)
        window, mask, _ = make_window(history, SEQ_LEN)
        _, items, _ = trainer.predict_top_k(
            grown, [{"feature_tensors": {"item_id": window[None]}, "padding_mask": mask[None]}], k=10
        )
        assert top_k_cut(response, 10)[0].tolist() == items[0].tolist()
    finally:
        service.close()
