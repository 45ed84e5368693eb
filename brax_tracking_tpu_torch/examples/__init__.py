"""Runnable examples of the port (``python -m brax_tracking_tpu_torch.examples.<name>``):
the offline policy replay, an env rollout demo and a contact-force demo."""
