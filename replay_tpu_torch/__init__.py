"""PyTorch/CUDA port of ``replay_tpu``, for NVIDIA Hopper.

A second package beside the JAX one, mirroring its layout and names: each
module here has its counterpart at the same path under ``replay_tpu/``, which
stays the reference the port is tested against. The port imports ``torch`` and
numpy and nothing of JAX or of the JAX package.

Every Pallas kernel of the JAX package becomes a kernel written by hand for
Hopper under ``replay_tpu_torch/csrc/``, with a plain PyTorch version of the
same function beside it (:mod:`replay_tpu_torch.ops`). Entry points default to
``device="cuda"`` and raise when there is none; ``device="cpu"`` runs the plain
versions.

Ported so far: SASRec serving through ``ScoringEngine`` on kernel K4 (fused
attention); SASRec training through ``nn.Trainer`` with ``CE`` or ``CEFused``
on kernels K1–K3 (the fused catalog log-sum-exp and its gradients) and K4 with
its gradient; the long-sequence route, ``SasRec(use_flash="tiled")`` on
kernel K5 (length-tiled attention, no ``[B, 1, L, L]`` mask), for training and
serving, with bf16 compute (``Trainer(precision="bf16")``, ``SasRec(dtype=...)``);
``ScoringService`` with brute-force, int8 and IVF retrieval and the exact
rescore; the compiled programs as CUDA graphs; BERT4Rec (masked-LM) and
TwoTower (in-batch negatives) on the same kernels, with the batch transforms
(``nn.transform``); notebook 09's training lifecycle from a raw log (the
pandas-free front end, the tokenizer and label encoders, ``SequenceBatcher``,
the packed and parquet batchers, checkpoints and exact resume, recovery and
preemption, dropout inside captured chunks) and the rest of ``Trainer.fit``
(health, tracing, profiling, the roofline, the metrics plane, the flight
recorder); every loss of the JAX package and the vocabulary surgery
(``resize_vocabulary``, ``finetune``); and the rest of the SASRec family:
remat and ``scan_blocks`` (``Trainer(remat_policy=...)``, the attention
kernels run again in the backward's recompute), the differential-attention
encoder, TiSasRec, and the list, numerical and identity embedders; notebook
09's test evaluation (``Trainer.predict_dataframe`` and
``predict_query_embeddings`` on the evaluation graphs, ``OfflineMetrics``,
``Experiment`` and every offline metric class on the host, returning
``ColumnTable``s) and the rest of the single-device API (``utils.trace``,
``StepTimer``, ``TensorBoardLogger``, ``MetricsBuilder.load_state``,
``metrics_to_df``, ``UniformBatching``, ``DefaultAttentionMask``,
``CompileTracker.wrap``); and distributed training (:mod:`replay_tpu_torch.parallel`:
``Trainer(mesh=make_mesh(...), shard_vocab=..., sharding_rules=...)`` over
``torch.distributed`` ranks, data parallelism, the vocab-sharded ``CEFusedTP``
head on K1–K3 per catalog shard, ring attention over the sequence
(``use_flash="ring"``), the multi-process checkpoint backend and the worker
launcher); and the serving fleet with the observability plane
(:mod:`replay_tpu_torch.serve`: ``ServingFleet`` behind the consistent-hash
router, in-process and HTTP replicas (``python -m replay_tpu_torch.serve.remote``),
``PromotionController``; the service's metrics, SLO, quality and flight-ring
planes; :mod:`replay_tpu_torch.obs`: the quality monitor, fleet federation,
merged traces, ``python -m replay_tpu_torch.obs.report`` and post-mortems).
Still to come, in ``ROADMAP.md``'s order: the classical and experimental
models, the port's benchmark, and the rest of distributed training (the
mesh-sharded retrieval index, graph capture of mesh steps with NCCL).
"""
