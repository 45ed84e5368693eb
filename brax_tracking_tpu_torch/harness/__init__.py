"""Experiment harness: config composition, the driver, metrics and eval
artifacts. Counterpart of ``brax_tracking_tpu/harness`` less rendering
(ROADMAP A.13)."""
