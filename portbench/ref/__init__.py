"""The frozen plain engine of the benchmark's check: the port's plain
physics and tracking env (``brax_tracking_tpu_torch`` at commit e658539),
copied so that no later change to the program moves the yardstick, and
trimmed to what the rodent and pair configurations run: a model from its
frozen ``.npz``, the single-clip tracking env under the training wrappers,
the clip's features, and the CG solve on the kernel's layout in its plain
version, on any device (no kernel is launched). It imports nothing of the
port, and nothing of JAX. ``portbench/tests/test_portbench_ref_jax.py``
holds it against the JAX package's engine at both configurations' models.
"""
