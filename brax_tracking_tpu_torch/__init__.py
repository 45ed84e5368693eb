"""PyTorch/CUDA port of brax_tracking_tpu for NVIDIA Hopper (H100).

The layout mirrors the JAX package (``physics/``, ``math/``, ``ops/``,
``envs/``, ``data/``) with the same module and function names, so each
module's counterpart is easy to find. Tensors are batch-first ``(B, ...)``;
static structure (contact slots, constraint rows, the kinematic plan) is
fixed as numpy at model-build time.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without CUDA a default call raises. float64 on the CPU
(parity with the JAX package), float32 on the card.
"""
