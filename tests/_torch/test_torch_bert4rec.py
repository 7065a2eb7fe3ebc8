"""The port's BERT4Rec against the JAX package's, on weights carried across.

The port's ``Bert4Rec`` draws its weights from a seed; ``convert.torch_to_flax``
carries them into the JAX ``Bert4Rec``; the same numpy inputs (left-padded
rows, one all padding) go through both, on every attention route (unfused, K4,
K5 non-causal; the JAX side runs Pallas in interpret mode, the port its
kernels' plain versions). Hidden states, ``forward_inference`` with and
without candidates, ``get_query_embeddings`` and ``get_logits`` within atol
1e-5 / rtol 1e-5 (f32, summation orders differ). Training: three
``Trainer.train_step``s of each package from the same weights on the same
JAX-made masked-LM batches, losses within rtol 1e-4 and parameters within
atol 1e-5 (``test_torch_train.py``'s limits). The serving programs: the
``"logits"`` mode is the shifted ``forward_inference``; the ``"hidden"`` mode
keeps the JAX definition, the model's forward at the last position with no
shift, pinned against the JAX ``CompiledInference``. Mirrors
``tests/nn/test_bert4rec.py``.
"""

import io
import zipfile

import numpy as np
import pytest
import torch

import jax

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn.compiled import CompiledInference as JaxCompiledInference
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.sequential.bert4rec import Bert4Rec as JaxBert4Rec
from replay_tpu.nn.transform import Compose as JaxCompose
from replay_tpu.nn.transform import make_default_bert4rec_transforms as jax_mlm_transforms
from replay_tpu_torch.convert import flax_to_torch, torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.compiled import CompiledInference, _read_sections
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.sequential import Bert4Rec
from replay_tpu_torch.nn.train import Trainer
from replay_tpu_torch.nn.transform import Compose, make_default_bert4rec_transforms

NUM_ITEMS, DIM, BLOCKS, HEADS, SEQ_LEN, BATCH = 50, 16, 2, 2, 8, 4
WIDTH = dict(embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS, max_sequence_length=SEQ_LEN)
ATOL = RTOL = 1e-5
STEPS = 3


def jax_schema():
    return TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )


def port_schema():
    return PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )


def port_model(use_flash=True, seed=0, **kwargs):
    return Bert4Rec(
        port_schema(), use_flash=use_flash, device="cpu", generator=torch.Generator().manual_seed(seed),
        **WIDTH, **kwargs,
    )


def windows(seed=0):
    """ids [B, L] left-padded with the padding id (cardinality), one row full,
    one all padding; a token mask with some real tokens masked."""
    rng = np.random.default_rng(seed)
    lengths = np.array([SEQ_LEN, 5, 1, 0])
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
    ids = np.where(mask, rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN)), NUM_ITEMS).astype(np.int32)
    token_mask = rng.random((BATCH, SEQ_LEN)) > 0.3
    return ids, mask, token_mask


@pytest.fixture(scope="module")
def params():
    return torch_to_flax(port_model().state_dict())


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_convert_round_trip_is_exact(params):
    tree = params
    assert {"mask_embedding", "positional_embedding", "embedder", "input_norm", "encoder", "final_norm"} == set(
        tree["body"]
    )
    assert tree["body"]["mask_embedding"].shape == (DIM,)
    assert tree["body"]["positional_embedding"].shape == (SEQ_LEN, DIM)
    state = flax_to_torch({"params": tree})
    back = torch_to_flax(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)
    # the JAX model's own init has the same tree (its shapes, traced only)
    ids, mask, _ = windows()
    init = jax.eval_shape(
        JaxBert4Rec(schema=jax_schema(), **WIDTH).init, jax.random.PRNGKey(0), {"item_id": ids}, mask
    )["params"]
    assert jax.tree.map(lambda x: tuple(x.shape), init) == jax.tree.map(np.shape, tree)


@pytest.mark.parametrize(
    "use_flash, with_token_mask", [(False, True), (True, False), (True, True), ("tiled", True)]
)
def test_hidden_states_match(params, use_flash, with_token_mask):
    ids, mask, token_mask = windows(1)
    jax_model = JaxBert4Rec(schema=jax_schema(), use_flash=use_flash, **WIDTH)
    port = port_model(use_flash)
    port.load_state_dict(flax_to_torch(params))
    extra = {"token_mask": token_mask} if with_token_mask else {}
    want = jax.jit(lambda variables: jax_model.apply(variables, {"item_id": ids}, mask, **extra))({"params": params})
    with torch.no_grad():
        got = port({"item_id": torch.tensor(ids)}, torch.tensor(mask), **{k: torch.tensor(v) for k, v in extra.items()})
    assert np.isfinite(got.numpy()).all()
    close(got, want)


def test_scoring_methods_match(params):
    """On the K4 route, which the card runs."""
    use_flash = True
    ids, mask, _ = windows(2)
    rng = np.random.default_rng(3)
    flat = rng.integers(0, NUM_ITEMS, 7).astype(np.int32)
    per_row = rng.integers(0, NUM_ITEMS, (BATCH, 5)).astype(np.int32)
    jax_model = JaxBert4Rec(schema=jax_schema(), use_flash=use_flash, **WIDTH)
    port = port_model(use_flash)
    port.load_state_dict(flax_to_torch(params))
    tensors, pmask = {"item_id": torch.tensor(ids)}, torch.tensor(mask)
    hidden = np.random.default_rng(4).standard_normal((BATCH, SEQ_LEN, DIM)).astype(np.float32)
    candidate_sets = (None, flat, per_row)

    @jax.jit
    def jax_outputs(variables):  # one compile for every output
        return (
            [jax_model.apply(variables, {"item_id": ids}, mask, c, method=JaxBert4Rec.forward_inference)
             for c in candidate_sets],
            jax_model.apply(variables, {"item_id": ids}, mask, method=JaxBert4Rec.get_query_embeddings),
            jax_model.apply(variables, hidden, method=JaxBert4Rec.get_logits),
            jax_model.apply(variables, method=JaxBert4Rec.get_item_weights),
        )

    inferred, queries, logits, weights = jax_outputs({"params": params})
    with torch.no_grad():
        for candidates, want in zip(candidate_sets, inferred):
            got = port.forward_inference(tensors, pmask, None if candidates is None else torch.tensor(candidates))
            close(got, want)
        close(port.get_query_embeddings(tensors, pmask), queries)
        close(port.get_logits(torch.tensor(hidden)), logits)
        close(port.get_item_weights(), weights)


def test_unported_routes_and_packed_rows_raise():
    ids, mask, _ = windows()
    # packed rows are ported on the unfused route only; the kernel route
    # refuses them as the JAX model does
    with pytest.raises(ValueError, match="the flash kernels cannot honor"):
        port_model()({"item_id": torch.tensor(ids)}, torch.tensor(mask), segment_ids=torch.ones(BATCH, SEQ_LEN))
    with pytest.raises(NotImplementedError, match="distributed training"):
        port_model("ring")({"item_id": torch.tensor(ids)}, torch.tensor(mask))
    # remat is ported (tests/_torch/test_torch_remat.py): a remat model's
    # hidden states are the plain model's
    rematted = port_model(remat=True, remat_policy=None)
    assert rematted.remat and rematted.body.encoder.remat
    with torch.no_grad():
        tensors = ({"item_id": torch.tensor(ids)}, torch.tensor(mask))
        assert torch.equal(rematted(*tensors), port_model()(*tensors))
    # the vocabulary surgery is ported (tests/_torch/test_torch_vocabulary.py):
    # a BERT4Rec trainer grows its table and refuses a shrink
    trainer = Trainer(port_model(), CE(), device="cpu")
    state = trainer.init_state(None)
    grown = trainer.resize_vocabulary(state, NUM_ITEMS + 5)
    assert trainer.model.get_item_weights().shape[0] == NUM_ITEMS + 5
    with pytest.raises(ValueError, match="cannot shrink"):
        trainer.finetune(grown, [], new_cardinality=NUM_ITEMS)


def test_from_params_excludes_the_query_id():
    schema = PortTensorSchema([
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        ),
        PortTensorFeatureInfo(
            "user_id", PortFeatureType.CATEGORICAL, feature_hint=PortFeatureHint.QUERY_ID, cardinality=9,
            embedding_dim=DIM,
        ),
    ])
    model = Bert4Rec.from_params(schema, embedding_dim=DIM, num_heads=HEADS, max_sequence_length=SEQ_LEN, device="cpu")
    assert model.body.embedder.feature_names == ["item_id"]
    assert model.body.dropout_rate == 0.3


# --------------------------------------------------------------------------- #
# training against the JAX trainer
# --------------------------------------------------------------------------- #
def mlm_batches():
    """The JAX pipeline's masked-LM batches (its draws), as numpy."""
    pipeline = JaxCompose(jax_mlm_transforms(jax_schema(), mask_prob=0.3)["train"])
    batches = []
    for seed in range(STEPS):
        ids, mask, _ = windows(10 + seed)
        ids[1] = np.arange(SEQ_LEN)  # every batch the same layout: no all-padding row here
        mask[1] = True
        batch = pipeline({"item_id": ids, "item_id_mask": mask}, jax.random.PRNGKey(seed))
        batches.append(jax.tree.map(np.asarray, batch))
    return batches


@pytest.fixture(scope="module")
def jax_run(params):
    trainer = JaxTrainer(model=JaxBert4Rec(schema=jax_schema(), use_flash=True, **WIDTH), loss=JaxCE())
    batches = mlm_batches()
    state = trainer.init_state(batches[0], params=params)
    losses = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return batches, losses, jax.tree.map(np.asarray, state.params)


def test_train_steps_match_jax(params, jax_run):
    batches, jax_losses, jax_params = jax_run
    trainer = Trainer(port_model(), CE(), device="cpu")
    seen = []
    trainer.model.body.register_forward_pre_hook(lambda module, args, kwargs: seen.append(kwargs.get("token_mask")), with_kwargs=True)
    state = trainer.init_state(batches[0], params=flax_to_torch(params))
    losses = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    # the batch's token_mask reached the model through the signature filter
    assert len(seen) == STEPS and all(mask is not None for mask in seen)
    np.testing.assert_array_equal(seen[0].numpy(), batches[0]["token_mask"])
    got = torch_to_flax({name: value.detach() for name, value in state.params.items()})
    for path, want in jax.tree_util.tree_leaves_with_path(jax_params):
        node, start = got, params
        for key in path:
            node, start = node[key.key], start[key.key]
        name = jax.tree_util.keystr(path)
        if "['key']['bias']" in name:
            # a bias on the keys adds one constant to a query's every score: its
            # gradient is zero up to rounding noise, which Adam scales to ±lr
            # per step on either side, so it can only stay within STEPS·lr
            assert np.abs(node - start).max() <= STEPS * 1e-3 * 1.01, name
            continue
        np.testing.assert_allclose(node, want, atol=1e-5, err_msg=name)


def test_chunked_steps_carry_the_token_mask(params, jax_run):
    """``train_steps`` stacks every leaf of the masked-LM batch, token_mask
    included, and equals the per-step path bit for bit."""
    batches = jax_run[0]
    runs = []
    for chunked in (False, True):
        trainer = Trainer(port_model(), CE(), device="cpu")
        state = trainer.init_state(batches[0], params=flax_to_torch(params))
        if chunked:
            state, losses = trainer.train_steps(state, batches)
        else:
            losses = [float(trainer.train_step(state, batch)[1]) for batch in batches]
        runs.append((np.asarray(losses, np.float32), state.flat_params.clone()))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_port_pipeline_trains_with_bf16_compute():
    """The port's own MLM pipeline and the bf16 rung: finite, falling loss."""
    pipeline = Compose(make_default_bert4rec_transforms(port_schema(), mask_prob=0.3)["train"])
    trainer = Trainer(port_model(), CE(), device="cpu", precision="bf16")
    assert trainer.model.dtype == torch.bfloat16
    generator = torch.Generator().manual_seed(0)
    ids, mask, _ = windows(20)
    state, losses = None, []
    for _ in range(6):
        batch = pipeline({"item_id": ids, "item_id_mask": mask}, generator)
        state = state or trainer.init_state(batch)
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# --------------------------------------------------------------------------- #
# serving programs
# --------------------------------------------------------------------------- #
def test_logits_mode_is_the_shifted_inference_and_serializes(params):
    model = port_model()
    model.load_state_dict(flax_to_torch(params))
    compiled = CompiledInference.compile(model, model.state_dict(), SEQ_LEN, batch_size=BATCH, device="cpu")
    ids, mask, _ = windows(5)
    got = compiled(ids[:3], mask[:3])
    with torch.no_grad():
        want = model.forward_inference({"item_id": torch.tensor(ids[:3])}, torch.tensor(mask[:3]))
    assert torch.equal(got, want)
    payload = compiled.serialize()
    # the params travel once, in the npz: no bucket's blob keeps the example inputs
    for blob in list(_read_sections(payload))[2:]:
        entries = zipfile.ZipFile(io.BytesIO(blob)).infolist()
        assert sum(e.file_size for e in entries if "sample_inputs" in e.filename) == 0
    served = CompiledInference.deserialize(payload, device="cpu")
    assert torch.equal(served(ids[:3], mask[:3]), got)


def test_hidden_mode_keeps_the_jax_definition(params):
    """``outputs="hidden"`` / ``"both"``: the model's forward at the last
    position, no mask token appended, as the JAX ``CompiledInference``
    defines it; it is not ``get_query_embeddings``."""
    model = port_model()
    model.load_state_dict(flax_to_torch(params))
    ids, mask, _ = windows(6)
    both = CompiledInference.compile(model, model.state_dict(), SEQ_LEN, batch_size=BATCH, outputs="both", device="cpu")
    logits, hidden = both(ids, mask)
    tensors, pmask = {"item_id": torch.tensor(ids)}, torch.tensor(mask)
    with torch.no_grad():
        assert torch.equal(hidden, model(tensors, pmask)[:, -1, :])
        assert torch.equal(logits, model.get_logits(hidden))
        assert not torch.allclose(hidden, model.get_query_embeddings(tensors, pmask))
    jax_model = JaxBert4Rec(schema=jax_schema(), use_flash=True, **WIDTH)
    jax_both = JaxCompiledInference.compile(jax_model, params, SEQ_LEN, batch_size=BATCH, outputs="both")
    for got, want in zip((logits, hidden), jax_both(ids, mask)):
        close(got, want)
