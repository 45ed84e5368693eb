"""Training building blocks of the port: transitions, the action
distribution, observation statistics, gradient updates, rollouts and
evals, checkpoints. Counterpart of ``brax_tracking_tpu/training``."""
