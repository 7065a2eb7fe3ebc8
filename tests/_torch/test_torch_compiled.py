"""``CompiledInference`` of the port: the serialized form against the live
instance and against the JAX package, on the CPU.

On the card every bucket is a captured CUDA graph (``chip_smoke.py`` holds the
replays bitwise to the eager program); here, on the CPU, each bucket runs the
bound program eagerly, and what is tested is the rest of the contract:

* ``serialize`` → ``deserialize`` and ``export_inference`` →
  ``import_inference`` round trips in every mode (``batch``, ``one_query``,
  ``dynamic_batch_size``) and output mode (``logits``, ``hidden``, ``both``),
  with and without candidates, on the K4 route (``use_flash=True``, whose
  forward is a registered operator inside the exported program) and the K5
  route (``"tiled"``): scores bitwise equal to the live port instance, since
  the params stay program arguments.
* The JAX live and deserialized instances on the same converted weights
  (Pallas in interpret mode): scores within atol 1e-5 / rtol 1e-5, the
  tolerance of ``test_torch_serve_engine.py`` (f32 in another summation order
  through two encoder blocks). Mirrors ``tests/models/test_ann_and_compiled.py``.
* ``swap_params`` after ``deserialize``, a re-serialize, a bad magic, a
  routing-only instance refusing to serialize, ``roofline()`` raising.
* The launch counts through graphs (``ops/counts.py``): a launch on a stream
  that is capturing is recorded, not counted, and counted once per replay.
"""

import numpy as np
import pytest
import torch

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn.compiled import CompiledInference as JaxCompiledInference
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu_torch.convert import torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.compiled import CompiledInference, export_inference, import_inference
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.ops import counts

NUM_ITEMS, DIM, SEQ_LEN = 50, 16, 8
WIDTH = dict(embedding_dim=DIM, num_blocks=2, num_heads=2, max_sequence_length=SEQ_LEN)
CANDIDATES = np.array([3, 7, 11, 42], np.int32)
ATOL = RTOL = 1e-5


def port_model(use_flash=True, seed=0):
    schema = PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    return SasRec(schema, use_flash=use_flash, device="cpu", generator=torch.Generator().manual_seed(seed), **WIDTH)


def windows(batch, seed=5):
    """Left-padded windows, one of them a single item."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, SEQ_LEN + 1, batch)
    lengths[0] = 1
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
    ids = np.where(mask, rng.integers(0, NUM_ITEMS, (batch, SEQ_LEN)), 0).astype(np.int32)
    return ids, mask


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def assert_bitwise(got, want):
    got, want = as_tuple(got), as_tuple(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# each mode, each output mode, each with and without candidates where it
# scores, the K4 route and the K5 route (one export per bucket each)
CASES = [
    ("batch", "logits", False, True),
    ("batch", "logits", True, True),
    ("batch", "both", False, True),
    ("one_query", "hidden", False, True),
    ("one_query", "both", True, "tiled"),
    ("dynamic_batch_size", "both", True, True),
]


@pytest.mark.parametrize(
    "mode, outputs, with_candidates, use_flash", CASES,
    ids=[f"{m}-{o}-{'cands' if c else 'catalog'}-flash={f}" for m, o, c, f in CASES],
)
def test_serialize_round_trip_is_bitwise(mode, outputs, with_candidates, use_flash):
    model = port_model(use_flash)
    compiled = CompiledInference.compile(
        model, model.state_dict(), SEQ_LEN, batch_size=4, mode=mode, dynamic_buckets=(1, 4),
        candidates_count=len(CANDIDATES) if with_candidates else None, outputs=outputs, device="cpu",
    )
    served = CompiledInference.deserialize(compiled.serialize(), device="cpu")
    assert (served.buckets, served.mode, served.outputs, served.max_sequence_length) == (
        compiled.buckets, mode, outputs, SEQ_LEN,
    )
    kwargs = {"candidates": CANDIDATES} if with_candidates else {}
    for batch in sorted({1, 3, max(compiled.buckets)}):
        if batch > max(compiled.buckets):
            continue
        ids, mask = windows(batch)
        assert_bitwise(served(ids, mask, **kwargs), compiled(ids, mask, **kwargs))
    if with_candidates:
        with pytest.raises(ValueError, match="candidates shape"):
            served(ids, mask, candidates=[1, 2])


def test_export_inference_round_trip_is_bitwise():
    model = port_model()
    payload = export_inference(model, model.state_dict(), SEQ_LEN, batch_size=4, device="cpu")
    served = import_inference(payload, device="cpu")
    ids, mask = windows(4)
    want = model.forward_inference({"item_id": torch.as_tensor(ids)}, torch.as_tensor(mask))
    assert_bitwise(served(ids, mask), want.detach())


def test_swap_after_deserialize_and_reserialize():
    model, other = port_model(seed=0), port_model(seed=1)
    compiled = CompiledInference.compile(model, model.state_dict(), SEQ_LEN, batch_size=4, outputs="both", device="cpu")
    served = CompiledInference.deserialize(compiled.serialize(), device="cpu")
    ids, mask = windows(3)
    swapped = dict(other.state_dict())
    served.swap_params(swapped)
    compiled.swap_params(swapped)
    assert_bitwise(served(ids, mask), compiled(ids, mask))
    # the per-call override wins for one call only
    assert_bitwise(
        served(ids, mask, params=dict(model.state_dict())),
        CompiledInference.compile(model, model.state_dict(), SEQ_LEN, batch_size=4, outputs="both", device="cpu")(
            ids, mask
        ),
    )
    # a deserialized instance re-serializes its blobs with the swapped params
    twice = CompiledInference.deserialize(served.serialize(), device="cpu")
    assert_bitwise(twice(ids, mask), compiled(ids, mask))
    table = "body.embedder.embedding_item_id.table.weight"
    grown = {**swapped, table: torch.zeros(NUM_ITEMS + 2, DIM)}
    with pytest.raises(ValueError, match=f"cannot hot-swap.*{table}.*has shape"):
        served.swap_params(grown)


def test_refusals():
    with pytest.raises(ValueError, match="bad magic"):
        CompiledInference.deserialize(b"not a payload", device="cpu")
    chooser = CompiledInference(dict.fromkeys((1, 4)), SEQ_LEN, "dynamic_batch_size", device="cpu")
    with pytest.raises(ValueError, match="no executables"):
        chooser.serialize()
    # buckets without a program have no roofline record (the records of real
    # buckets: test_torch_roofline.py)
    assert chooser.roofline() == {}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX live instance and its round trip, on the port model's weights."""
    model = port_model()
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    jax_model = JaxSasRec(schema=schema, use_flash=True, **WIDTH)
    live = JaxCompiledInference.compile(
        jax_model, torch_to_flax(model.state_dict()), SEQ_LEN, mode="dynamic_batch_size",
        dynamic_buckets=(1, 4), candidates_count=len(CANDIDATES), outputs="both",
    )
    return model, live, JaxCompiledInference.deserialize(live.serialize())


def test_scores_match_the_jax_live_and_deserialized_instances(jax_side):
    model, jax_live, jax_served = jax_side
    compiled = CompiledInference.compile(
        model, model.state_dict(), SEQ_LEN, mode="dynamic_batch_size", dynamic_buckets=(1, 4),
        candidates_count=len(CANDIDATES), outputs="both", device="cpu",
    )
    served = CompiledInference.deserialize(compiled.serialize(), device="cpu")
    for batch in (1, 3, 4):
        ids, mask = windows(batch, seed=batch)
        got = served(ids, mask, candidates=CANDIDATES)
        for jax_instance in (jax_live, jax_served):
            want = jax_instance(ids, mask, candidates=CANDIDATES)
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)


def test_launches_on_a_capturing_stream_count_once_per_replay():
    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by_variant = 0, {"a": 0, "b": 0}
    with counts.recording(0x1000) as recorded:
        counts.launched(wrapper, 0x1000, "a")  # the capturing stream: recorded
        counts.launched(wrapper, 0x2000, "b")  # another stream: counted at once
        with pytest.raises(RuntimeError, match="already recording"):
            with counts.recording(0x1000):
                pass
    assert (wrapper.launches, wrapper.launches_by_variant) == (1, {"a": 0, "b": 1})
    assert recorded == [(wrapper, "a")]
    for _ in range(3):  # three replays
        counts.add_recorded(recorded)
    assert (wrapper.launches, wrapper.launches_by_variant) == (4, {"a": 3, "b": 1})
    counts.launched(wrapper, 0x1000, "a")  # the capture ended: counted again
    assert wrapper.launches_by_variant["a"] == 4
