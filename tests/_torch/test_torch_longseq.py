"""The long-sequence route (``use_flash="tiled"``, kernel K5) and bf16 compute,
the port against the JAX package, on the CPU.

A small SASRec (E=16, 2 blocks, 2 heads, L=40, left-padded rows) on weights
drawn by JAX and carried across with ``convert.flax_to_torch``. The JAX side
runs the tiled Pallas kernel in interpret mode, the port its plain version.

Tolerances, and why:

* f32 hidden states and logits: rtol/atol 2e-5, the JAX tiled test's own
  (the same f32 arithmetic summed in another order). Padded rows are compared
  nowhere: on the tiled route a left-padded row has no valid key and K5 gives
  0, where the unfused route applies its diagonal rescue; the ``keep`` mask
  zeroes those rows after every block, so only real rows are the model's
  output.
* bf16 compute: both packages round every activation to bf16 (8 significant
  bits) but not always at the same step (torch's ``addmm`` adds the bias
  before its one rounding, flax rounds the product and then the sum), so
  outputs agree within a few bf16 ulps: rtol/atol 2**-5 on O(1) hidden states.
* Trainer steps: losses rtol 1e-4 in f32 (the JAX package's own CEFused-vs-CE
  tolerance), tight enough to catch a K5 with its softmax scale off by 2**-7
  or with bf16 scores (``test_f32_trainer_parity_catches_a_faulty_k5``); with
  ``precision="bf16"`` rtol 2**-8: the two packages round bf16 activations at
  different steps and Adam at lr 1e-2 carries the difference through four
  steps, a noise as large as such a fault, so the bf16 case holds the
  precision plumbing (compute dtype, f32 master weights and moments) and the
  f32 case the kernel.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn import OptimizerFactory as JaxOptimizerFactory
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn import precision as jax_precision
from replay_tpu.nn.loss import CEFused as JaxCEFused
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.serve.engine import ScoringEngine as JaxScoringEngine
from replay_tpu_torch.convert import flax_to_torch, torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn import mask as port_mask
from replay_tpu_torch.nn import precision as port_precision
from replay_tpu_torch.nn.layers import Dense, Embed, LayerNorm
from replay_tpu_torch.nn.loss import CEFused
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
from replay_tpu_torch.ops import flash_tiled
from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled
from replay_tpu_torch.serve import ScoringEngine

NUM_ITEMS, DIM, BLOCKS, HEADS, SEQ_LEN, BATCH = 60, 16, 2, 2, 40, 4
WIDTH = dict(embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS, max_sequence_length=SEQ_LEN)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2**-5, atol=2**-5)
STEPS = 4


def jax_model(use_flash="tiled", dtype=jnp.float32):
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    return JaxSasRec(schema=schema, use_flash=use_flash, dtype=dtype, **WIDTH)


def port_model(use_flash="tiled", dtype=torch.float32):
    schema = PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    return SasRec(schema, use_flash=use_flash, dtype=dtype, device="cpu", **WIDTH)


def windows(seed, batch=BATCH):
    """Left-padded windows (padding id = cardinality), the first row full."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(3, SEQ_LEN + 1, batch)
    lengths[0] = SEQ_LEN
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
    items = rng.integers(0, NUM_ITEMS, (batch, SEQ_LEN + 1)).astype(np.int32)
    return np.where(mask, items[:, :-1], NUM_ITEMS).astype(np.int32), mask, items


def train_batch(seed):
    ids, mask, items = windows(seed)
    return {
        "feature_tensors": {"item_id": ids},
        "padding_mask": mask,
        "positive_labels": items[:, 1:, None],
        "target_padding_mask": mask[:, :, None],
    }


@pytest.fixture(scope="module")
def params():
    """A JAX init of the tiled model: f32 leaves (a bf16 model's are the same)."""
    ids, mask, _ = windows(0)
    tree = jax_model().init(jax.random.PRNGKey(0), {"item_id": ids}, mask)["params"]
    return jax.tree.map(np.asarray, tree)


def _hidden_both(params, dtype_pair, use_flash="tiled"):
    ids, mask, _ = windows(1)
    jdtype, tdtype = dtype_pair
    want = jax_model(use_flash, jdtype).apply({"params": params}, {"item_id": ids}, mask)
    port = port_model(use_flash, tdtype)
    port.load_state_dict(flax_to_torch(params))
    got = port({"item_id": torch.tensor(ids)}, torch.tensor(mask))
    return got, want, mask


def test_tiled_model_matches_jax_on_real_rows(params):
    got, want, mask = _hidden_both(params, (jnp.float32, torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy()[mask], np.asarray(want)[mask], **F32_TOL)


def test_tiled_route_matches_the_unfused_route_on_real_rows(params):
    ids, mask, _ = windows(2)
    tiled, plain = port_model("tiled"), port_model(False)
    state = flax_to_torch(params)
    tiled.load_state_dict(state)
    plain.load_state_dict(state)
    tensors = {"item_id": torch.tensor(ids)}, torch.tensor(mask)
    np.testing.assert_allclose(
        tiled(*tensors).detach().numpy()[mask], plain(*tensors).detach().numpy()[mask], **F32_TOL
    )
    np.testing.assert_allclose(
        tiled.forward_inference(*tensors).detach().numpy(), plain.forward_inference(*tensors).detach().numpy(),
        **F32_TOL,
    )


def test_bf16_tiled_model_matches_jax_on_real_rows(params):
    got, want, mask = _hidden_both(params, (jnp.bfloat16, torch.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        got.float().detach().numpy()[mask], np.asarray(want.astype(jnp.float32))[mask], **BF16_TOL
    )


def test_bf16_model_keeps_f32_parameters_and_item_weights(params):
    """get_item_weights() stays f32 under a bf16 compute dtype, in both packages,
    so full-catalog logits promote to f32; converted params load unchanged."""
    model = jax_model(dtype=jnp.bfloat16)
    weights = model.apply({"params": params}, method=JaxSasRec.get_item_weights)
    assert weights.dtype == jnp.float32
    assert {leaf.dtype for leaf in jax.tree.leaves(params)} == {np.dtype(np.float32)}
    port = port_model(dtype=torch.bfloat16)
    state = flax_to_torch(params)
    assert {t.dtype for t in state.values()} == {torch.float32}
    port.load_state_dict(state)
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    assert port.get_item_weights().dtype == torch.float32
    flat = torch_to_flax(port.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        node = flat
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    ids, mask, _ = windows(3)
    logits = port.forward_inference({"item_id": torch.tensor(ids)}, torch.tensor(mask))
    want = model.apply({"params": params}, {"item_id": ids}, mask, method=JaxSasRec.forward_inference)
    assert logits.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), **BF16_TOL)


def test_compute_dtype_layers_round_where_flax_rounds():
    """The layers cast explicitly, as flax's Dense, LayerNorm and Embed with
    dtype=bf16 do: Dense casts input and kernel and returns bf16; LayerNorm
    computes its statistics in f32 and returns bf16; Embed casts the table
    before the gather."""
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(5, DIM)) * 3).astype(np.float32)
    ids = rng.integers(0, 7, (3, 4)).astype(np.int32)
    dense = fnn.Dense(8, dtype=jnp.bfloat16)
    dense_params = jax.tree.map(np.asarray, dense.init(jax.random.PRNGKey(1), x)["params"])
    dense_params["bias"] = rng.normal(size=8).astype(np.float32)
    norm = fnn.LayerNorm(dtype=jnp.bfloat16)
    norm_params = {"scale": rng.normal(size=DIM).astype(np.float32), "bias": rng.normal(size=DIM).astype(np.float32)}
    embed = fnn.Embed(7, DIM, dtype=jnp.bfloat16)
    embed_params = jax.tree.map(np.asarray, embed.init(jax.random.PRNGKey(2), ids)["params"])

    port_dense = Dense(DIM, 8, torch.bfloat16)
    port_dense.load_state_dict(flax_to_torch(dense_params))
    port_norm = LayerNorm(DIM, torch.bfloat16)
    port_norm.load_state_dict(flax_to_torch(norm_params))
    port_embed = Embed(7, DIM, torch.bfloat16)
    port_embed.load_state_dict(flax_to_torch(embed_params))
    cases = (
        (port_dense(torch.tensor(x)), dense.apply({"params": dense_params}, x)),
        (port_norm(torch.tensor(x).to(torch.bfloat16)), norm.apply({"params": norm_params}, x.astype(jnp.bfloat16))),
        (port_embed(torch.tensor(ids)), embed.apply({"params": embed_params}, ids)),
    )
    for got, want in cases:
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert all(p.dtype == torch.float32 for p in (*port_dense.parameters(), *port_norm.parameters()))
        # one bf16 ulp at the outputs' magnitude: both round an f32 result once
        np.testing.assert_allclose(
            got.float().detach().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2**-7, atol=2**-7
        )
    # the embedding is exact: a gather of the bf16-cast table
    assert torch.equal(cases[2][0].float(), torch.tensor(np.asarray(cases[2][1].astype(jnp.float32))))


def test_tiled_route_builds_no_square_mask(params, monkeypatch):
    """No [B, 1, L, L] tensor on the tiled route: the additive-mask builder is
    replaced by one that raises, and the model, a training step and the
    engine all run."""

    def refuse(*args, **kwargs):
        raise AssertionError("a [B, 1, L, L] mask was built on the tiled route")

    monkeypatch.setattr(port_mask, "_additive", refuse)
    model = port_model(dtype=torch.bfloat16)
    model.load_state_dict(flax_to_torch(params))
    ids, mask, _ = windows(4)
    assert model({"item_id": torch.tensor(ids)}, torch.tensor(mask)).shape == (BATCH, SEQ_LEN, DIM)
    trainer = Trainer(model, CEFused(), device="cpu")
    state = trainer.init_state(train_batch(5))
    _, loss = trainer.train_step(state, train_batch(5))
    assert torch.isfinite(loss)
    engine = ScoringEngine(model, model.state_dict(), length_buckets=(16, SEQ_LEN), batch_buckets=(1, 4), device="cpu")
    logits, hidden = engine.encode(16, ids[:, -16:], mask[:, -16:])
    assert logits.shape == (BATCH, NUM_ITEMS) and torch.isfinite(logits).all()
    with pytest.raises(AssertionError, match="mask was built"):
        port_model(False)({"item_id": torch.tensor(ids)}, torch.tensor(mask))


def test_misuse_guards_match_jax():
    """A non-SASRec encoder on the tiled route is refused at construction (the
    JAX refusal), and an unknown encoder is a ValueError. The diff encoder is
    ported (tests/_torch/test_torch_sasrec_family.py): off the tiled route it
    builds, on the unfused route and with use_flash=True alike."""
    for bad in ("diff", "nope"):
        with pytest.raises(ValueError, match="tiled" if bad == "diff" else "Unknown encoder_type"):
            SasRec(port_model().body.embedder.schema, encoder_type=bad, use_flash="tiled", device="cpu", **WIDTH)
    for use_flash in (False, True):
        diff = SasRec(port_model().body.embedder.schema, encoder_type="diff", use_flash=use_flash, device="cpu", **WIDTH)
        assert type(diff.body.encoder).__name__ == "DiffTransformerLayer"


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
BATCHES = [train_batch(10 + i) for i in range(STEPS)]


TRAIN_OPTIMIZER = dict(name="adam", learning_rate=1e-2)


def _jax_losses(params, precision):
    jax_trainer = JaxTrainer(
        model=jax_model(), loss=JaxCEFused(tile=8), optimizer=JaxOptimizerFactory(**TRAIN_OPTIMIZER),
        precision=precision,
    )
    state = jax_trainer.init_state(BATCHES[0], params=params)
    want = []
    for batch in BATCHES:
        state, loss = jax_trainer.train_step(state, batch)
        want.append(float(loss))
    return want


@pytest.fixture(scope="module")
def jax_losses(params):
    """``_jax_losses`` by precision, each computed once for the module (the
    f32 losses are the reference of three tests)."""
    cache = {}

    def losses(precision):
        if precision not in cache:
            cache[precision] = _jax_losses(params, precision)
        return cache[precision]

    return losses


def _port_losses(params, precision):
    model = port_model()
    trainer = Trainer(
        model, CEFused(), optimizer=OptimizerFactory(**TRAIN_OPTIMIZER), precision=precision, device="cpu"
    )
    port_state = trainer.init_state(BATCHES[0], params=flax_to_torch(params))
    got = []
    for batch in BATCHES:
        port_state, loss = trainer.train_step(port_state, batch)
        got.append(float(loss))
    return got, model, trainer, port_state


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_train_steps_match_the_jax_trainer(params, jax_losses, precision):
    want = jax_losses(precision)
    got, model, trainer, port_state = _port_losses(params, precision)
    np.testing.assert_allclose(got, want, rtol=1e-4 if precision is None else 2**-8)
    assert got[-1] < got[0] and int(port_state.bad_steps) == 0
    # master parameters, optimizer moments and the sentinel stay f32
    assert port_state.flat_params.dtype == torch.float32
    assert all(t.dtype == torch.float32 for link in port_state.opt_state for k, t in link.items() if k != "count")
    expected = torch.bfloat16 if precision == "bf16" else torch.float32
    assert trainer.model.dtype == expected and (trainer.model is model) == (precision is None)
    assert model.dtype == torch.float32  # the caller's model is cloned, not changed


def _scale_fault(q, k, v, kv_bias, causal):
    """A faulty K5: its softmax scale off by 2**-7 (1/sqrt(65) for 1/sqrt(64) is 0.8%)."""
    return flash_tiled.flash_attention_tiled_reference(q * (1 + 2**-7), k, v, kv_bias, causal)


def _bf16_scores_fault(q, k, v, kv_bias, causal):
    """A faulty K5: its scores rounded to bf16 before the softmax."""
    positions = torch.arange(q.shape[2])
    s = (torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])).to(torch.bfloat16).float()
    s = s + kv_bias[:, None, None, :]
    if causal:
        s = s.masked_fill(positions[None, :] > positions[:, None], flash_tiled.NEG_INF)
    probs = torch.where(s <= flash_tiled.NEG_INF / 2, 0.0, torch.softmax(s, dim=-1))
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    lse = torch.logsumexp(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs / denom, v), lse


@pytest.mark.parametrize("fault", [_scale_fault, _bf16_scores_fault], ids=["scale", "bf16_scores"])
def test_f32_trainer_parity_catches_a_faulty_k5(params, jax_losses, fault, monkeypatch):
    """The f32 trainer check (rtol 1e-4) is tight enough to catch a subtly
    wrong K5: the kernel's forward swapped for a faulty one moves the port's
    losses further than 1e-4 from the JAX trainer's."""
    want = jax_losses(None)
    monkeypatch.setattr(flash_tiled, "_forward", fault)
    got = _port_losses(params, None)[0]
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) > 1e-4


def test_precision_on_a_tiled_model_launches_nothing_on_the_cpu(params):
    before = flash_attention_tiled.launches
    trainer = Trainer(port_model(), CEFused(), precision="bf16", device="cpu")
    state = trainer.init_state(BATCHES[0], params=flax_to_torch(params))
    trainer.train_step(state, BATCHES[0])
    assert flash_attention_tiled.launches == before


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scoring_engine_on_a_tiled_model_matches_the_jax_engine(params, dtype):
    buckets = dict(length_buckets=(16, SEQ_LEN), batch_buckets=(1, 4))
    jax_engine = JaxScoringEngine(jax_model(dtype=getattr(jnp, dtype)), params, **buckets)
    port = port_model(dtype=getattr(torch, dtype))
    engine = ScoringEngine(port, flax_to_torch(params), device="cpu", **buckets)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    ids, mask, _ = windows(6, batch=3)
    for length in (16, SEQ_LEN):
        got_logits, got_hidden = engine.encode(length, ids[:, -length:], mask[:, -length:])
        want_logits, want_hidden = jax_engine.encode(length, ids[:, -length:], mask[:, -length:])
        assert got_logits.dtype == torch.float32 and got_hidden.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **tol)
        np.testing.assert_allclose(
            got_hidden.float().numpy(), np.asarray(jnp.asarray(want_hidden).astype(jnp.float32)), **tol
        )
    # a hot swap of f32 parameters goes through the same programs
    swapped = {name: value * 0.5 for name, value in flax_to_torch(params).items()}
    engine.swap_params(swapped)
    fresh = ScoringEngine(port, swapped, device="cpu", **buckets)
    got, _ = engine.encode(SEQ_LEN, ids, mask)
    want, _ = fresh.encode(SEQ_LEN, ids, mask)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="dtype"):
        engine.swap_params({name: value.to(torch.bfloat16) for name, value in swapped.items()})


# --------------------------------------------------------------------------- #
# the precision policy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("spec", [None, "f32", "float32", "bf16", "BFloat16"])
def test_precision_resolve_and_describe_match_jax(spec):
    want = jax_precision.Precision.resolve(spec)
    got = port_precision.Precision.resolve(spec)
    if spec is None:
        assert got is None and want is None
        return
    assert got.describe() == want.describe()
    assert (got.is_identity, got.casts_logits) == (want.is_identity, want.casts_logits)


def test_precision_misuse_matches_jax():
    for module in (jax_precision, port_precision):
        with pytest.raises(ValueError, match="Unknown precision"):
            module.Precision.resolve("fp8")
        with pytest.raises(TypeError, match="precision must be"):
            module.Precision.resolve(16)
        with pytest.raises(ValueError, match="dtype"):
            module.Precision.bf16().apply_to_model(object())
    model = port_model()
    assert port_precision.Precision.f32().apply_to_model(model) is model
    clone = port_precision.Precision.bf16().apply_to_model(model)
    assert clone is not model and clone.dtype == torch.bfloat16 and clone.use_flash == "tiled"
    for (name, a), b in zip(model.state_dict().items(), clone.state_dict().values()):
        assert torch.equal(a, b), name
    assert port_precision.Precision.bf16().apply_to_model(clone) is clone
    logits = port_precision.Precision.bf16().wrap_logits_callback(lambda: torch.ones(2, dtype=torch.bfloat16))()
    assert logits.dtype == torch.float32


def test_fit_parity_record_matches_jax():
    base = [{"epoch": 0, "train_loss": 4.0, "ndcg@10": 0.20}, {"epoch": 1, "train_loss": 3.5, "ndcg@10": 0.25}]
    for cand_final in (0.24, 0.2, float("nan")):
        cand = [{"epoch": 0, "train_loss": 4.1, "ndcg@10": 0.19}, {"epoch": 1, "train_loss": 3.6, "ndcg@10": cand_final}]
        got = port_precision.fit_parity_record(base, cand)
        want = jax_precision.fit_parity_record(base, cand)
        assert got.keys() == want.keys()
        for key in want:
            if isinstance(want[key], float) and np.isnan(want[key]):
                assert np.isnan(got[key]), key
            else:
                assert got[key] == want[key], key
    assert port_precision.PARITY_REL_TOL == jax_precision.PARITY_REL_TOL
    for module in (jax_precision, port_precision):
        with pytest.raises(KeyError, match="absent"):
            module.fit_parity_record(base, [{"train_loss": 1.0}])


def test_cefused_dtype_check_matches_jax():
    """bf16 hidden states against the f32 table are the sanctioned split in
    both packages; two different narrow floats are refused in both."""
    cases = [(jnp.bfloat16, jnp.float32, True), (jnp.float32, jnp.float32, True),
             (jnp.bfloat16, jnp.float16, False), (jnp.float32, jnp.int8, False)]
    for h_dt, t_dt, ok in cases:
        jax_loss, port_loss = JaxCEFused(), CEFused()
        hidden, table = np.zeros((2, 4)), np.zeros((3, 4))
        jax_call = lambda: jax_loss._check_dtypes(jnp.asarray(hidden, h_dt), jnp.asarray(table, t_dt))  # noqa: E731
        port_call = lambda: port_loss._check_dtypes(  # noqa: E731
            torch.zeros(2, 4, dtype=getattr(torch, jnp.dtype(h_dt).name)),
            torch.zeros(3, 4, dtype=getattr(torch, jnp.dtype(t_dt).name)),
        )
        for call in (jax_call, port_call):
            if ok:
                call()
            else:
                with pytest.raises(ValueError, match="sanctioned"):
                    call()
