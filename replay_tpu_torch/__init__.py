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
``ScoringService`` with brute-force retrieval; the compiled programs as CUDA
graphs; BERT4Rec (masked-LM) and TwoTower (in-batch negatives) on the same
kernels, with the batch transforms (``nn.transform``) and the sampled and
weighted cross-entropy losses; and notebook 09's training lifecycle: the
pandas-free ``SequentialDataset``, ``SequenceBatcher`` and
``validation_batches`` (``data.nn``), checkpoints (``utils.checkpoint``),
resume, best-state tracking and early stop, recovery and preemption in
``Trainer.fit``, the event sinks, and dropout inside captured chunks. Still to
come, in ``ROADMAP.md``'s order: quantized and IVF retrieval, the tokenizer
and label encoders (pandas), the parquet and packed batchers, profiling,
tracing and health in ``fit``, the vocabulary, the other losses and models,
distributed training and the serving fleet.
"""
