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
attention), and SASRec training through ``nn.Trainer`` with ``CE`` or
``CEFused`` on kernels K1–K3 (the fused catalog log-sum-exp and its
gradients) and K4 with its gradient. Still to come, in ``ROADMAP.md``'s order:
the long-sequence route on K5, the service, retrieval and the other models.
"""
