"""Experiment harness: config composition, the driver, the launcher,
metrics, eval artifacts and videos. Counterpart of
``brax_tracking_tpu/harness``."""
