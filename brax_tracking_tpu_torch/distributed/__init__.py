"""Data-parallel training over ``torch.distributed`` ranks (one process per
card). Counterpart of ``brax_tracking_tpu/distributed``."""
