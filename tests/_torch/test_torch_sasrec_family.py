"""The rest of the SASRec family against the JAX package, on weights carried across.

Each module goes through the JAX package and the port on the same numpy
inputs (from a seed) and the same weights (``convert.flax_to_torch``): the
list, numerical and identity embedders and ``SequenceEmbedding``'s choice
among them, ``xavier_normal_embed_init``, ``ConcatAggregator``, ``RMSNorm``,
the differential attention and the ``encoder_type="diff"`` SASRec, and
TiSasRec with int64, float64 and float32 timestamps (among them a row with one
valid item). The weights are drawn by the port from a seed and carried to the
JAX models (checked against the JAX param tree's shapes). A training batch's
loss and gradients of the diff SASRec and of a SASRec over list and numerical
features are held to ``jax.value_and_grad``'s, and three train steps of
TiSasRec (float timestamps through the trainer) to the JAX trainer's. f32
throughout: atol/rtol 1e-5 on values (summation orders differ between XLA and
torch), gradients atol 1e-5 / rtol 1e-4, losses after three Adam steps rtol
1e-4 and parameters atol 1e-5, as ``test_torch_train.py`` holds them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn import OptimizerFactory as JaxOptimizerFactory
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn import embedding as jax_embedding
from replay_tpu.nn.agg import ConcatAggregator as JaxConcatAggregator
from replay_tpu.nn.attention import MultiHeadDifferentialAttention as JaxDiffAttention
from replay_tpu.nn.attention import RMSNorm as JaxRMSNorm
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.mask import causal_attention_mask as jax_causal_mask
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.nn.sequential.sasrec import TiSasRec as JaxTiSasRec
from replay_tpu_torch import nn as port_nn
from replay_tpu_torch.convert import flax_to_torch, torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn import attention as port_attention
from replay_tpu_torch.nn import layers
from replay_tpu_torch.nn.embedding import (
    CategoricalListEmbedding,
    IdentityEmbedding,
    NumericalEmbedding,
    SequenceEmbedding,
    xavier_normal_embed_init,
)
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.mask import causal_attention_mask
from replay_tpu_torch.nn.sequential.sasrec import SasRec, TiSasRec
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer

ATOL = RTOL = 1e-5
NUM_ITEMS, DIM, SEQ_LEN, BATCH, GENRES, GENRE_SLOTS = 40, 16, 8, 4, 18, 6
STEPS, LR = 3, 1e-2


def close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def schemas(*specs):
    """The JAX and the port schema of the same features: ``(name, type,
    kwargs)`` with the type's name."""
    def build(info, feature_type, hint, schema):
        features = []
        for name, kind, kwargs in specs:
            extra = dict(kwargs)
            if extra.pop("item", False):
                extra["feature_hint"] = hint.ITEM_ID
            features.append(info(name, getattr(feature_type, kind), is_seq=True, **extra))
        return schema(features)

    return (
        build(TensorFeatureInfo, FeatureType, FeatureHint, TensorSchema),
        build(PortTensorFeatureInfo, PortFeatureType, PortFeatureHint, PortTensorSchema),
    )


ITEM = ("item_id", "CATEGORICAL", dict(item=True, cardinality=NUM_ITEMS, embedding_dim=DIM))
GENRE = ("genres", "CATEGORICAL_LIST", dict(cardinality=GENRES, embedding_dim=DIM))
PRICE = ("price", "NUMERICAL", dict(tensor_dim=1, embedding_dim=DIM))
TIMESTAMP = ("timestamp", "NUMERICAL", dict(tensor_dim=1, embedding_dim=DIM))


def left_padded(rng, lengths=(SEQ_LEN, 5, 1, 3)):
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - np.asarray(lengths)[:, None]
    ids = np.where(mask, rng.integers(0, NUM_ITEMS, (len(lengths), SEQ_LEN + 1))[:, :SEQ_LEN], NUM_ITEMS)
    return ids.astype(np.int32), mask


def genre_lists(rng, shape):
    """Up to GENRE_SLOTS genres per position, padded with GENRES; one list
    empty and one with a repeated genre (a tie for max pooling)."""
    lists = rng.integers(0, GENRES, (*shape, GENRE_SLOTS))
    keep = np.arange(GENRE_SLOTS) < rng.integers(1, GENRE_SLOTS + 1, shape)[..., None]
    lists = np.where(keep, lists, GENRES)
    lists[0, 0] = GENRES
    lists[0, 1, :3] = (2, 2, GENRES)
    return lists.astype(np.int32)


# --------------------------------------------------------------------------- #
# embedders
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("pooling", ["sum", "mean", "max"])
def test_list_embedding_matches_jax(pooling):
    rng = np.random.default_rng(0)
    ids = genre_lists(rng, (BATCH, SEQ_LEN))
    cotangent = rng.normal(size=(BATCH, SEQ_LEN, DIM)).astype(np.float32)
    module = jax_embedding.CategoricalListEmbedding(
        cardinality=GENRES, embedding_dim=DIM, padding_value=GENRES, pooling=pooling
    )
    params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(0), ids)["params"])

    def value(p):
        out = module.apply({"params": p}, ids)
        return jnp.sum(out * cotangent), out

    (_, want), grads = jax.jit(jax.value_and_grad(value, has_aux=True))(params)
    port = CategoricalListEmbedding(GENRES, DIM, padding_value=GENRES, pooling=pooling)
    port.load_state_dict(flax_to_torch(params))
    got = port(torch.tensor(ids))
    close(got, want)
    assert not got[0, 0].any()  # a list with no valid entry pools to 0
    (got * torch.tensor(cotangent)).sum().backward()
    close(port.table.weight.grad, grads["table"]["embedding"])
    # bf16 compute: max picks table values, so it is exact; the fill is bf16's min
    if pooling == "max":
        bf16 = jax_embedding.CategoricalListEmbedding(
            cardinality=GENRES, embedding_dim=DIM, padding_value=GENRES, pooling="max", dtype=jnp.bfloat16
        )
        want16 = bf16.apply({"params": params}, ids).astype(jnp.float32)
        port16 = CategoricalListEmbedding(GENRES, DIM, GENRES, "max", dtype=torch.bfloat16)
        port16.load_state_dict(port.state_dict())
        np.testing.assert_array_equal(port16(torch.tensor(ids)).detach().float().numpy(), np.asarray(want16))
    with pytest.raises(ValueError, match="Unknown pooling: min"):
        CategoricalListEmbedding(GENRES, DIM, pooling="min")


def test_fixed_order_table_gradient_is_the_embedding_gradient(monkeypatch):
    """``nn/layers.py::table_gradient``, the card's fixed-order gradient of a
    table looked up many times a row (torch's CUDA kernel does not repeat
    there), equals torch's embedding gradient; ``Embed`` takes it through its
    autograd Function with the same gradient, in f32 and bf16 compute."""
    rng = np.random.default_rng(11)
    ids = torch.tensor(genre_lists(rng, (BATCH, SEQ_LEN)))
    grad = torch.tensor(rng.normal(size=(BATCH, SEQ_LEN, GENRE_SLOTS, DIM)).astype(np.float32))
    native = torch.ops.aten.embedding_dense_backward(grad, ids, GENRES + 1, -1, False)
    close(layers.table_gradient(ids, grad, GENRES + 1), native, atol=1e-6, rtol=1e-6)
    assert layers.table_gradient(ids, grad.bfloat16(), GENRES + 1).dtype == torch.bfloat16
    assert not layers._repeatable_gradient(ids, torch.zeros(GENRES + 1, DIM, requires_grad=True))  # on the CPU: torch's
    for dtype in (torch.float32, torch.bfloat16):
        plain = CategoricalListEmbedding(GENRES, DIM, GENRES, "sum", dtype=dtype)
        taken = []
        with monkeypatch.context() as patch:
            patch.setattr(layers, "_repeatable_gradient", lambda ids, table: taken.append(1) or True)
            fixed = CategoricalListEmbedding(GENRES, DIM, GENRES, "sum", dtype=dtype)
            fixed.load_state_dict(plain.state_dict())
            cotangent = torch.tensor(rng.normal(size=(BATCH, SEQ_LEN, DIM)).astype(np.float32))
            (fixed(ids).float() * cotangent).sum().backward()
        (plain(ids).float() * cotangent).sum().backward()
        assert taken
        # bf16: the fixed order sums in f32 and rounds once; torch's CPU
        # kernel rounds its bf16 partial sums, so they part by a bf16 ulp or two
        tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 else dict(atol=2e-2, rtol=1e-2)
        close(fixed.table.weight.grad, plain.table.weight.grad, **tol)


@pytest.mark.parametrize("tensor_dim", [1, 3])
def test_numerical_embedding_matches_jax(tensor_dim):
    rng = np.random.default_rng(1)
    shape = (BATCH, SEQ_LEN) if tensor_dim == 1 else (BATCH, SEQ_LEN, tensor_dim)
    values = rng.normal(size=shape).astype(np.float32)
    module = jax_embedding.NumericalEmbedding(embedding_dim=DIM)
    params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(1), values)["params"])
    port = NumericalEmbedding(DIM, tensor_dim=tensor_dim)
    port.load_state_dict(flax_to_torch(params))
    assert set(port.state_dict()) == {"proj.weight", "proj.bias"}
    close(port(torch.tensor(values)), module.apply({"params": params}, values))
    identity = IdentityEmbedding()
    assert not list(identity.parameters())
    np.testing.assert_array_equal(identity(torch.tensor(values)).numpy(), values)


def test_sequence_embedding_picks_the_jax_embedders():
    """Categorical → table, categorical list → pooled table, numerical →
    ``proj``, a numerical list as wide as its embedding → identity; the
    flax names, and every feature's output, match."""
    specs = (
        ITEM, GENRE, PRICE,
        ("vector", "NUMERICAL_LIST", dict(tensor_dim=DIM, embedding_dim=DIM)),
        ("narrow", "NUMERICAL_LIST", dict(tensor_dim=4, embedding_dim=DIM)),
    )
    jax_schema, port_schema = schemas(*specs)
    rng = np.random.default_rng(2)
    ids, _ = left_padded(rng)
    features = {
        "item_id": ids, "genres": genre_lists(rng, (BATCH, SEQ_LEN)),
        "price": rng.normal(size=(BATCH, SEQ_LEN)).astype(np.float32),
        "vector": rng.normal(size=(BATCH, SEQ_LEN, DIM)).astype(np.float32),
        "narrow": rng.normal(size=(BATCH, SEQ_LEN, 4)).astype(np.float32),
    }
    module = jax_embedding.SequenceEmbedding(schema=jax_schema, categorical_list_pooling="mean")
    params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(2), features)["params"])
    want = module.apply({"params": params}, features)
    port = SequenceEmbedding(port_schema, categorical_list_pooling="mean")
    kinds = {name: type(port.embedder(name)).__name__ for name in port.feature_names}
    assert kinds == {
        "item_id": "CategoricalEmbedding", "genres": "CategoricalListEmbedding", "price": "NumericalEmbedding",
        "vector": "IdentityEmbedding", "narrow": "NumericalEmbedding",
    }
    assert port.embedder("genres").pooling == "mean"
    state = flax_to_torch(params)
    assert sorted(state) == sorted(port.state_dict())
    port.load_state_dict(state)
    got = port({name: torch.tensor(value) for name, value in features.items()})
    assert sorted(got) == sorted(want)
    for name in want:
        close(got[name], want[name])


def test_xavier_normal_embed_init():
    """std sqrt(2 / (V + D)) from a normal truncated at two of its σ, as the
    JAX init draws it; a SasRec built with it draws its item table so, where
    flax's default gives std 1/sqrt(D)."""
    rows, dim = 3001, 16
    table = torch.empty(rows, dim)
    xavier_normal_embed_init()(table, torch.Generator().manual_seed(0))
    jax_table = np.asarray(jax_embedding.xavier_normal_embed_init()(jax.random.PRNGKey(0), (rows, dim)))
    want_std = np.sqrt(2.0 / (rows + dim))
    for drawn in (table.numpy(), jax_table):
        assert abs(drawn.std() / want_std - 1) < 0.03
        assert np.abs(drawn).max() <= 2 * want_std / 0.87962566103423978 + 1e-7
    _, port_schema = schemas(("item_id", "CATEGORICAL", dict(item=True, cardinality=rows - 1, embedding_dim=dim)))
    model = SasRec(port_schema, embedding_dim=dim, num_blocks=1, max_sequence_length=4, device="cpu",
                   embedding_init=xavier_normal_embed_init())
    assert abs(model.get_item_weights().detach().std().item() / want_std - 1) < 0.03
    default = SasRec(port_schema, embedding_dim=dim, num_blocks=1, max_sequence_length=4, device="cpu")
    assert abs(default.get_item_weights().detach().std().item() * np.sqrt(dim) - 1) < 0.03
    # clone keeps the init argument
    assert model.clone()._config["embedding_init"] is model._config["embedding_init"]


def test_concat_aggregator_matches_jax():
    rng = np.random.default_rng(3)
    embeddings = {
        "b": rng.normal(size=(BATCH, SEQ_LEN, 4)).astype(np.float32),
        "a": rng.normal(size=(BATCH, SEQ_LEN, 6)).astype(np.float32),
    }
    module = JaxConcatAggregator(output_dim=DIM)
    params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(3), embeddings)["params"])
    port = port_nn.ConcatAggregator(10, DIM)
    port.load_state_dict(flax_to_torch(params))
    close(port({k: torch.tensor(v) for k, v in embeddings.items()}), module.apply({"params": params}, embeddings))
    # sorted-key order: "a"'s six columns come first in the projection
    close(port.proj.weight[:, :6].T, params["proj"]["kernel"][:6])


# --------------------------------------------------------------------------- #
# differential attention
# --------------------------------------------------------------------------- #
def test_rmsnorm_matches_jax():
    x = np.random.default_rng(4).normal(size=(BATCH, SEQ_LEN, DIM)).astype(np.float32) * 1e-2
    scale = np.linspace(0.5, 1.5, DIM).astype(np.float32)
    want = JaxRMSNorm().apply({"params": {"scale": scale}}, x)
    port = port_attention.RMSNorm(DIM)
    port.load_state_dict(flax_to_torch({"scale": scale}))
    close(port(torch.tensor(x)), want)


def halves_attention(module, x, mask):
    """The trap: a head's two maps taken as the first and second halves of the
    2H maps, not interleaved. Another model; the parity test must tell."""
    *lead, dim = x.shape
    maps, head_dim = 2 * module.num_heads, dim // (2 * module.num_heads)
    q = module.query(x).reshape(*lead, maps, head_dim).transpose(-3, -2)
    k = module.key(x).reshape(*lead, maps, head_dim).transpose(-3, -2)
    v = module.value(x).reshape(*lead, module.num_heads, 2 * head_dim).transpose(-3, -2)
    weights = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", q, k) / head_dim**0.5 + mask, dim=-1)
    w1, w2 = weights[:, : module.num_heads], weights[:, module.num_heads :]
    lam = (torch.exp(module.lambda_q1 @ module.lambda_k1) - torch.exp(module.lambda_q2 @ module.lambda_k2)
           + module.lambda_init)
    out = module.head_norm(torch.einsum("bhqk,bhkd->bhqd", w1 - lam * w2, v)) * (1 - module.lambda_init)
    return module.out(out.transpose(-3, -2).reshape(*lead, dim))


@pytest.mark.parametrize("heads", [1, 2])
def test_differential_attention_matches_jax(heads):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(BATCH, SEQ_LEN, DIM)).astype(np.float32)
    _, mask = left_padded(rng)
    additive = np.asarray(jax_causal_mask(mask, deterministic=True))
    cotangent = rng.normal(size=(BATCH, SEQ_LEN, DIM)).astype(np.float32)
    module = JaxDiffAttention(num_heads=heads, lambda_init=0.35)
    params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(5), x, additive)["params"])

    def value(p, x):
        out = module.apply({"params": p}, x, additive)
        return jnp.sum(out * cotangent), out

    (_, want), (param_grads, x_grad) = jax.jit(jax.value_and_grad(value, argnums=(0, 1), has_aux=True))(params, x)
    port = port_attention.MultiHeadDifferentialAttention(DIM, heads, lambda_init=0.35)
    state = flax_to_torch(params)
    assert sorted(state) == sorted(port.state_dict())  # no biases: the flax tree has none either
    port.load_state_dict(state)
    xt = torch.tensor(x, requires_grad=True)
    got = port(xt, torch.tensor(additive))
    close(got, want)
    (got * torch.tensor(cotangent)).sum().backward()
    close(xt.grad, x_grad)
    grads = {name: p.grad for name, p in port.named_parameters()}
    for name, want_grad in flax_to_torch(param_grads).items():
        close(grads[name], want_grad, atol=1e-5, rtol=1e-4)
    if heads > 1:
        halves = halves_attention(port, torch.tensor(x), torch.tensor(additive)).detach().numpy()
        assert np.abs(halves - np.asarray(want)).max() > 1e-3  # the case would catch the halves split
    with pytest.raises(ValueError, match="divisible by 2\\*num_heads"):
        port_attention.MultiHeadDifferentialAttention(DIM, 3)


# --------------------------------------------------------------------------- #
# models: hidden states, scoring, and three train steps against the JAX trainer
# --------------------------------------------------------------------------- #
def carried(port_model, jax_model, features, mask):
    """The port model's weights (drawn from its seed) as a flax tree, checked
    leaf by leaf against the shapes of the JAX model's own tree (a JAX init
    would compile one more program); the round trip is exact."""
    params = torch_to_flax(port_model.state_dict())
    with jax.ensure_compile_time_eval():
        shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), features, mask)["params"]
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)):
        assert got.shape == want.shape and got.dtype == want.dtype
    back = flax_to_torch(params)
    assert all(torch.equal(back[name], value) for name, value in port_model.state_dict().items())
    return params


def port_tensors(features):
    return {name: torch.tensor(value) for name, value in features.items()}


def next_item_batches(rng, extra, count=STEPS):
    """Left-padded next-item batches, with the extra per-position features ``extra(rng)``."""
    batches = []
    for _ in range(count):
        ids, mask = left_padded(rng)
        labels = np.where(mask, rng.integers(0, NUM_ITEMS, ids.shape), NUM_ITEMS).astype(np.int32)
        batches.append({
            "feature_tensors": {"item_id": ids, **extra(rng, mask)},
            "padding_mask": mask,
            "positive_labels": labels[:, :, None],
            "target_padding_mask": mask[:, :, None],
        })
    return batches


def train_against_jax(jax_model, port_model, batches, params):
    """Three Adam steps of each trainer from ``params``: losses rtol 1e-4,
    every parameter atol 1e-5; returns both trainers and states."""
    jax_trainer = JaxTrainer(model=jax_model, loss=JaxCE(), optimizer=JaxOptimizerFactory(learning_rate=LR))
    jax_state = jax_trainer.init_state(batches[0], params=params)
    port = Trainer(port_model, CE(), optimizer=OptimizerFactory(learning_rate=LR), device="cpu")
    state = port.init_state(batches[0], params=flax_to_torch(params))
    want, got = [], []
    for batch in batches:
        jax_state, loss = jax_trainer.train_step(jax_state, batch)
        want.append(float(loss))
        state, loss = port.train_step(state, batch)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    trained = torch_to_flax(port.model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jax_state.params)):
        node, start = trained, params
        for key in path:
            node, start = node[key.key], start[key.key]
        name = jax.tree_util.keystr(path)
        if "['key']['bias']" in name:
            # a bias on the keys adds one constant to a query's every score:
            # its gradient is rounding noise, which Adam scales to ±lr per
            # step on either side (test_torch_train.py bounds it the same way)
            assert np.abs(node - start).max() <= STEPS * LR * 1.01, name
            continue
        np.testing.assert_allclose(node, leaf, atol=1e-5, err_msg=name)
    return jax_trainer, jax_state, port, state


def loss_and_grads(jax_model, params, port_model, batch):
    """The CE loss of one batch and its gradient w.r.t. every parameter, by
    ``jax.value_and_grad`` on the JAX model and by autograd on the port's,
    the computation a train step differentiates."""
    def jax_loss(p):
        loss = JaxCE()
        loss.logits_callback = lambda hidden, candidates=None: jax_model.apply(
            {"params": p}, hidden, candidates, method=type(jax_model).get_logits
        )
        hidden = jax_model.apply({"params": p}, batch["feature_tensors"], batch["padding_mask"], deterministic=False)
        return loss(hidden, batch["feature_tensors"], batch["positive_labels"], None, batch["padding_mask"],
                    batch["target_padding_mask"])

    # the diff encoder's λ_init schedule calls float() on a jnp.exp of a
    # constant, which a jit trace refuses: evaluate constants at trace time
    with jax.ensure_compile_time_eval():
        want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    loss = CE()
    loss.logits_callback = port_model.get_logits
    tensors = {k: torch.tensor(v) for k, v in batch.items() if k != "feature_tensors"}
    hidden = port_model(port_tensors(batch["feature_tensors"]), tensors["padding_mask"], deterministic=False)
    value = loss(hidden, {}, tensors["positive_labels"], None, tensors["padding_mask"], tensors["target_padding_mask"])
    names = [name for name, _ in port_model.named_parameters()]
    grads = torch.autograd.grad(value, [p for _, p in port_model.named_parameters()])
    close(value, want_loss)
    want = flax_to_torch(jax.tree.map(np.asarray, want_grads))
    assert sorted(want) == sorted(names)
    for name, grad in zip(names, grads):
        close(grad, want[name], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("use_flash", [False, True])
def test_diff_sasrec_matches_jax(use_flash, monkeypatch):
    """The diff encoder ignores ``use_flash`` (and remat/scan), as in JAX: with
    ``use_flash=True`` it takes the [B, 1, L, L] mask and no kernel runs."""
    jax_schema, port_schema = schemas(ITEM)
    rng = np.random.default_rng(6)
    ids, mask = left_padded(rng)
    width = dict(embedding_dim=DIM, num_blocks=2, num_heads=2, max_sequence_length=SEQ_LEN, encoder_type="diff")
    jax_model = JaxSasRec(schema=jax_schema, use_flash=use_flash, **width)
    port = SasRec(port_schema, use_flash=use_flash, remat=True, scan_blocks=True, device="cpu", **width)
    params = carried(port, jax_model, {"item_id": ids}, mask)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the diff encoder launched an attention kernel")

    monkeypatch.setattr(port_attention, "flash_attention", no_kernel)
    monkeypatch.setattr(port_attention, "flash_attention_tiled", no_kernel)
    tensors = {"item_id": torch.tensor(ids)}
    with torch.no_grad():
        close(port(tensors, torch.tensor(mask)), jax_model.apply({"params": params}, {"item_id": ids}, mask))
        close(
            port.forward_inference(tensors, torch.tensor(mask)),
            jax_model.apply({"params": params}, {"item_id": ids}, mask, method=JaxSasRec.forward_inference),
        )
    if not use_flash:
        batch = next_item_batches(rng, lambda rng, mask: {}, count=1)[0]
        plain = SasRec(port_schema, device="cpu", **width)
        plain.load_state_dict(flax_to_torch(params))
        loss_and_grads(jax_model, params, plain, batch)


def test_diff_lambda_init_is_the_f32_schedule():
    _, port_schema = schemas(ITEM)
    model = SasRec(port_schema, embedding_dim=DIM, num_blocks=3, num_heads=2, encoder_type="diff", device="cpu")
    got = [getattr(model.body.encoder, f"attention_{i}").lambda_init for i in range(3)]
    want = [0.8 - 0.6 * float(jnp.exp(-0.3 * i)) for i in range(3)]
    assert got == want


def ti_timestamps(kind, mask):
    """Timestamps of each kind whose intervals differ with the cast order:
    float64 seconds near 1.6e9 (float32 resolves 128 s there) and int64
    seconds past 2**31 (int32 wraps); row 2 has one valid item."""
    rng = np.random.default_rng(7)
    gaps = rng.integers(1, 400, mask.shape)
    gaps[1, 3:] = (1, 1, 300, 256, 255)  # scaled gaps at and beside the clip boundary
    base = {"float64": 1.6e9, "int64": 2**31 + 5, "float32": 0.0}[kind]
    stamps = base + np.cumsum(gaps, axis=1)
    dtype = {"float64": np.float64, "int64": np.int64, "float32": np.float32}[kind]
    return stamps.astype(dtype)


@pytest.mark.parametrize("kind", ["int64", "float64", "float32"])
def test_tisasrec_matches_jax(kind):
    jax_schema, port_schema = schemas(ITEM, TIMESTAMP)
    rng = np.random.default_rng(8)
    ids, mask = left_padded(rng)
    stamps = ti_timestamps(kind, mask)
    width = dict(embedding_dim=DIM, num_blocks=2, num_heads=2, max_sequence_length=SEQ_LEN, time_span=256)
    jax_model = JaxTiSasRec(schema=jax_schema, **width)
    features = {"item_id": ids, "timestamp": stamps}
    port = TiSasRec(port_schema, device="cpu", **width)
    params = carried(port, jax_model, features, mask)
    tensors, pmask = port_tensors(features), torch.tensor(mask)
    want_ids = jax_model.apply({"params": params}, jnp.asarray(stamps), mask, method=JaxTiSasRec._intervals)
    got_ids = port._intervals(tensors["timestamp"], pmask)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    narrowed = torch.tensor(stamps).to({"int64": torch.int32, "float64": torch.float32}.get(kind, torch.float32))
    # clipped at the span; the row with one valid item has no positive gap, so its scale is 1
    raw = torch.abs(narrowed[2][:, None] - narrowed[2][None, :]).float()
    assert got_ids.max() == 256 and torch.equal(got_ids[2], torch.clamp(raw, 0, 256).to(torch.int32))
    if kind != "float32":
        # the trap: differences taken before the cast give other ids
        wide = torch.tensor(stamps)
        early = torch.clamp(torch.abs(wide[:, :, None] - wide[:, None, :]).float(), 0, 256).to(torch.int32)
        assert not torch.equal(early, got_ids)
    with torch.no_grad():
        close(port(tensors, pmask), jax_model.apply({"params": params}, features, mask))
        close(
            port.forward_inference(tensors, pmask),
            jax_model.apply({"params": params}, features, mask, method=JaxTiSasRec.forward_inference),
        )
    # without timestamps the bias is skipped, as in JAX
    with torch.no_grad():
        close(
            port({"item_id": tensors["item_id"]}, pmask),
            jax_model.apply({"params": params}, {"item_id": ids}, mask),
        )


def test_tisasrec_trains_like_jax():
    jax_schema, port_schema = schemas(ITEM, TIMESTAMP)
    rng = np.random.default_rng(9)
    width = dict(embedding_dim=DIM, num_blocks=1, num_heads=2, max_sequence_length=SEQ_LEN, time_span=16)

    def stamps(rng, mask):
        return {"timestamp": np.cumsum(rng.integers(1, 9, mask.shape), axis=1).astype(np.float32)}

    batches = next_item_batches(rng, stamps)
    jax_model = JaxTiSasRec(schema=jax_schema, **width)
    port = TiSasRec(port_schema, device="cpu", **width)
    params = carried(port, jax_model, batches[0]["feature_tensors"], batches[0]["padding_mask"])
    jax_trainer, jax_state, trainer, state = train_against_jax(jax_model, port, batches, params)
    query = {k: batches[0][k] for k in ("feature_tensors", "padding_mask")}
    close(trainer.predict_logits(state, query), jax_trainer.predict_logits(jax_state, query), atol=1e-4)


def test_sasrec_with_list_and_numerical_features_trains_like_jax():
    """A SASRec over item ids, a genre list (sum-pooled: the SASRec body's
    embedder takes the default pooling, as in JAX) and a numerical feature,
    tables drawn by ``xavier_normal_embed_init``: hidden states, then a
    training batch's loss and gradients."""
    jax_schema, port_schema = schemas(ITEM, GENRE, PRICE)
    rng = np.random.default_rng(10)

    def extra(rng, mask):
        return {
            "genres": genre_lists(rng, mask.shape),
            "price": rng.normal(size=mask.shape).astype(np.float32),
        }

    batches = next_item_batches(rng, extra)
    width = dict(embedding_dim=DIM, num_blocks=1, num_heads=1, max_sequence_length=SEQ_LEN)
    jax_model = JaxSasRec(schema=jax_schema, embedding_init=jax_embedding.xavier_normal_embed_init(), **width)
    features, mask = batches[0]["feature_tensors"], batches[0]["padding_mask"]
    port = SasRec(port_schema, embedding_init=xavier_normal_embed_init(), device="cpu", **width)
    assert type(port.body.embedder.embedder("price")).__name__ == "NumericalEmbedding"
    params = carried(port, jax_model, features, mask)
    with torch.no_grad():
        close(port(port_tensors(features), torch.tensor(mask)), jax_model.apply({"params": params}, features, mask))
    loss_and_grads(jax_model, params, port, batches[1])
