"""The port's SASRec against the JAX package's, on weights carried across.

A JAX ``SasRec`` is initialised from a seed; ``convert.flax_to_torch`` carries its
params into the port's ``SasRec``; the same numpy inputs (left-padded rows and
one all-padding row) go through both. Both attention routes are covered: on the
kernel route the JAX side runs the Pallas kernel in interpret mode and the
port its plain version. Tolerance atol 1e-5 / rtol 1e-5: f32 throughout, with
summation orders that differ between XLA and torch.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn.ffn import PointWiseFeedForward as JaxPointWiseFeedForward
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu_torch.convert import flax_to_torch, torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.ffn import PointWiseFeedForward
from replay_tpu_torch.nn.sequential.sasrec import SasRec

NUM_ITEMS, DIM, BLOCKS, HEADS, SEQ_LEN, BATCH = 50, 16, 2, 2, 8, 4
ATOL = RTOL = 1e-5


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


def batch(seed=0):
    """ids [B, L] with left padding (padding id = cardinality) and one all-padding row."""
    rng = np.random.default_rng(seed)
    lengths = np.array([SEQ_LEN, 5, 1, 0])
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
    ids = np.where(mask, rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN)), NUM_ITEMS).astype(np.int32)
    return ids, mask


@pytest.fixture(scope="module")
def jax_params():
    ids, mask = batch()
    model = JaxSasRec(
        schema=jax_schema(), embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS,
        max_sequence_length=SEQ_LEN,
    )
    params = model.init(jax.random.PRNGKey(0), {"item_id": ids}, mask)["params"]
    return jax.tree.map(np.asarray, params)


def models(params, use_flash):
    jax_model = JaxSasRec(
        schema=jax_schema(), embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS,
        max_sequence_length=SEQ_LEN, use_flash=use_flash,
    )
    port = SasRec(
        port_schema(), embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS,
        max_sequence_length=SEQ_LEN, use_flash=use_flash, device="cpu",
    )
    port.load_state_dict(flax_to_torch(params))
    return jax_model, port


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_convert_round_trip_is_exact(jax_params):
    state = flax_to_torch({"params": jax_params})
    back = torch_to_flax(state)
    assert jax.tree.structure(back) == jax.tree.structure(jax_params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jax_params)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    again = flax_to_torch(back)
    assert list(again) == list(state)
    assert all(torch.equal(again[name], state[name]) for name in state)


def test_converted_state_dict_fits_the_port_model(jax_params):
    port = SasRec(
        port_schema(), embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS,
        max_sequence_length=SEQ_LEN, device="cpu",
    )
    state = flax_to_torch(jax_params)
    expected = {name: tuple(t.shape) for name, t in port.state_dict().items()}
    assert {name: tuple(t.shape) for name, t in state.items()} == expected
    # a Dense kernel [in, out] arrives as a Linear weight [out, in]
    kernel = jax_params["body"]["encoder"]["block_0"]["ffn"]["inner"]["kernel"]
    np.testing.assert_array_equal(state["body.encoder.block_0.ffn.inner.weight"].numpy(), kernel.T)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("deterministic", [True, False])
def test_hidden_states_match(jax_params, use_flash, deterministic):
    jax_model, port = models(jax_params, use_flash)
    ids, mask = batch(1)
    want = jax_model.apply({"params": jax_params}, {"item_id": ids}, mask, deterministic=deterministic)
    with torch.no_grad():
        got = port({"item_id": torch.tensor(ids)}, torch.tensor(mask), deterministic=deterministic)
    assert np.isfinite(got.numpy()).all()
    close(got, want)


@pytest.mark.parametrize("use_flash", [False, True])
def test_scoring_methods_match(jax_params, use_flash):
    jax_model, port = models(jax_params, use_flash)
    ids, mask = batch(2)
    rng = np.random.default_rng(3)
    flat = rng.integers(0, NUM_ITEMS, 7).astype(np.int32)
    per_position = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN, 5)).astype(np.int32)
    variables = {"params": jax_params}
    tensors = {"item_id": torch.tensor(ids)}
    with torch.no_grad():
        for candidates in (None, flat):
            close(
                port.forward_inference(
                    tensors, torch.tensor(mask),
                    None if candidates is None else torch.tensor(candidates),
                ),
                jax_model.apply(
                    variables, {"item_id": ids}, mask, candidates_to_score=candidates,
                    method=JaxSasRec.forward_inference,
                ),
            )
        hidden = jax_model.apply(variables, {"item_id": ids}, mask)
        close(
            port.get_logits(torch.tensor(np.asarray(hidden)), torch.tensor(per_position)),
            jax_model.apply(variables, hidden, per_position, method=JaxSasRec.get_logits),
        )
        close(
            port.get_query_embeddings(tensors, torch.tensor(mask)),
            jax_model.apply(variables, {"item_id": ids}, mask, method=JaxSasRec.get_query_embeddings),
        )
        close(port.get_item_weights(), jax_model.apply(variables, method=JaxSasRec.get_item_weights))


def test_layer_norm_epsilon_is_flax_not_torch(jax_params):
    """flax LayerNorm uses eps 1e-6, torch 1e-5: on inputs whose variance is
    near 1e-6 the two differ by far more than the parity tolerance."""
    _, port = models(jax_params, False)
    norms = [port.body.final_norm] + [
        m for name, m in port.named_modules() if name.endswith(("attn_norm", "ffn_norm"))
    ]
    assert len(norms) == 1 + 2 * BLOCKS
    x = np.random.default_rng(4).normal(size=(3, DIM)).astype(np.float32) * 1e-3
    want = fnn.LayerNorm().apply({"params": {"scale": np.ones(DIM), "bias": np.zeros(DIM)}}, x)
    torch_default = torch.nn.LayerNorm(DIM)(torch.tensor(x)).detach().numpy()
    assert np.abs(torch_default - np.asarray(want)).max() > 0.1  # the case would catch eps=1e-5
    for norm in norms:
        close(norm(torch.tensor(x)), want)


def test_gelu_is_the_tanh_approximation():
    """flax nn.gelu is the tanh form; the FFN with gelu matches the JAX FFN on
    carried weights, where torch's exact gelu would not."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, SEQ_LEN, DIM)) * 3).astype(np.float32)
    jax_ffn = JaxPointWiseFeedForward(hidden_dim=4 * DIM, activation="gelu")
    params = jax.tree.map(np.asarray, jax_ffn.init(jax.random.PRNGKey(1), x)["params"])
    want = jax_ffn.apply({"params": params}, x)
    port = PointWiseFeedForward(DIM, 4 * DIM, activation="gelu")
    port.load_state_dict(flax_to_torch(params))
    close(port(torch.tensor(x)), want)
    exact = port.outer(torch.nn.functional.gelu(port.inner(torch.tensor(x)))) + torch.tensor(x)
    assert np.abs(exact.detach().numpy() - np.asarray(want)).max() > 1e-4  # the case would catch exact gelu
