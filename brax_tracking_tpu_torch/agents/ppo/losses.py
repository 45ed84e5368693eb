"""PPO loss: GAE targets, clipped surrogate, value and entropy terms.

Counterpart of ``brax_tracking_tpu/agents/ppo/losses.py``, term by term:
- GAE with truncation masking (deltas zeroed where the episode was cut by
  the time limit) and the bootstrap chain cut by ``termination``;
- advantages standardized over the whole minibatch with the population
  std (``jnp.std``'s ddof 0, not torch's default);
- value loss 0.25 * mean((vs - baseline)^2);
- the single-sample entropy estimate, its draw ``entropy_eps`` given.

Transitions arrive rows x time ``[B, T, ...]`` and are swapped to
time-major ``[T, B, ...]`` inside the loss; ``entropy_eps`` comes
``[B, T, action_size]`` and is swapped with them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from brax_tracking_tpu_torch.agents.ppo.networks import PPONetworks
from brax_tracking_tpu_torch.training.types import Transition


@torch.no_grad()
def compute_gae(
    truncation: torch.Tensor,
    termination: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    lambda_: float = 1.0,
    discount: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation over a time-major ``[T, B]`` batch.

    Returns (vs, advantages), neither carrying a gradient. ``truncation``
    marks time-limit cuts (no learning signal through them),
    ``termination`` true terminations (the value chain stops)."""
    truncation_mask = 1 - truncation
    values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    deltas = (rewards + discount * (1 - termination) * values_t_plus_1 - values) * truncation_mask
    acc = torch.zeros_like(bootstrap_value)
    vs_minus_v = torch.empty_like(deltas)
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + discount * (1 - termination[t]) * truncation_mask[t] * lambda_ * acc
        vs_minus_v[t] = acc
    vs = vs_minus_v + values
    vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
    advantages = (rewards + discount * (1 - termination) * vs_t_plus_1 - values) * truncation_mask
    return vs, advantages


def compute_ppo_loss(
    networks: PPONetworks,
    normalizer_params,
    data: Transition,
    entropy_eps: torch.Tensor,
    entropy_cost: float = 1e-4,
    discounting: float = 0.9,
    reward_scaling: float = 1.0,
    gae_lambda: float = 0.95,
    clipping_epsilon: float = 0.3,
    normalize_advantage: bool = True,
) -> Tuple[torch.Tensor, dict]:
    """Scalar PPO loss and its metrics over one minibatch of transitions
    (``[B, T, ...]``; ``next_observation`` ``[B, 1, obs]``, the bootstrap)."""
    dist = networks.parametric_action_distribution
    data = data.map(lambda x: x.transpose(0, 1))
    entropy_eps = entropy_eps.transpose(0, 1)

    policy_logits = networks.policy_logits(normalizer_params, data.observation)
    baseline = networks.value_fn(normalizer_params, data.observation)
    bootstrap_value = networks.value_fn(normalizer_params, data.next_observation[-1])

    rewards = data.reward * reward_scaling
    truncation = data.extras["state_extras"]["truncation"]
    termination = (1 - data.discount) * (1 - truncation)

    target_action_log_probs = dist.log_prob(policy_logits, data.extras["policy_extras"]["raw_action"])
    behaviour_action_log_probs = data.extras["policy_extras"]["log_prob"]

    vs, advantages = compute_gae(
        truncation=truncation,
        termination=termination,
        rewards=rewards,
        values=baseline.detach(),
        bootstrap_value=bootstrap_value.detach(),
        lambda_=gae_lambda,
        discount=discounting,
    )
    if normalize_advantage:
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
    rho_s = torch.exp(target_action_log_probs - behaviour_action_log_probs)

    surrogate_loss1 = rho_s * advantages
    surrogate_loss2 = torch.clamp(rho_s, 1 - clipping_epsilon, 1 + clipping_epsilon) * advantages
    policy_loss = -torch.mean(torch.minimum(surrogate_loss1, surrogate_loss2))

    v_error = vs - baseline
    v_loss = torch.mean(v_error * v_error) * 0.5 * 0.5

    entropy = torch.mean(dist.entropy(policy_logits, entropy_eps))
    entropy_loss = entropy_cost * -entropy

    total_loss = policy_loss + v_loss + entropy_loss
    return total_loss, {
        "total_loss": total_loss.detach(),
        "policy_loss": policy_loss.detach(),
        "v_loss": v_loss.detach(),
        "entropy_loss": entropy_loss.detach(),
    }
