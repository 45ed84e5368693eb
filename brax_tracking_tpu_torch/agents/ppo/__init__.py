"""PPO on one card: networks, losses, the trainer.

Counterpart of ``brax_tracking_tpu/agents/ppo``.
"""

from brax_tracking_tpu_torch.agents.ppo import losses as ppo_losses  # noqa: F401
from brax_tracking_tpu_torch.agents.ppo import networks as ppo_networks  # noqa: F401
from brax_tracking_tpu_torch.agents.ppo import train as _train  # noqa: F401

train_fn = _train.train
