"""The benchmark's own plain reference of the PPO learner.

Written from the published algorithm, not from the program: the clipped
surrogate objective of PPO (Schulman et al. 2017, arXiv:1707.06347) on
advantages from generalized advantage estimation (Schulman et al. 2016,
arXiv:1506.02438), with the conventions of Brax's PPO for continuous
control (``brax/training/agents/ppo``) that the configurations state:

- the policy and the value are MLPs with SiLU between the layers and
  nothing after the last; the policy emits a location and a pre-scale per
  action dimension, scale = softplus(pre-scale) + 0.001, and the action is
  tanh of a Gaussian draw, whose density carries the change of variables
  log(1 - tanh(u)^2);
- observations are normalized by running statistics (std held in
  [1e-6, 1e6]), which the first unroll sets: over one batch, its mean and
  population std;
- GAE with lambda over each minibatch's unroll: the value chain stops at a
  termination (discount 0 that is not a time-limit cut), and a time-limit
  cut (truncation) carries no learning signal; the policy's advantage is the
  one-step return on the GAE targets; advantages are standardized over the
  minibatch (population std, + 1e-8);
- the loss is the negated clipped surrogate, plus 0.25 times the mean
  squared error of the value against the targets, minus the entropy cost
  times a one-sample estimate of the squashed policy's entropy (the
  Gaussian's entropy plus log(1 - tanh(x)^2) at a drawn point);
- Adam (Kingma and Ba 2015): b1 0.9, b2 0.999, eps 1e-8 outside the square
  root, bias-corrected, no clipping.

Plain PyTorch in any dtype (float64 for the reference; the control runs it
in float32 with TF32 products); gradients by autograd through these
functions. It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

MIN_SCALE = 1e-3
STD_RANGE = (1e-6, 1e6)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def softplus(x):
    """log(1 + e^x), exact for every x."""
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def log_dtanh(u):
    """log(1 - tanh(u)^2) = -2 log cosh(u), stable for large |u|."""
    a = u.abs()
    return -2.0 * (a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0))


def mlp(layers: Layers, x):
    """Dense layers (W (out, in), b), SiLU between them."""
    for i, (w, b) in enumerate(layers):
        x = x @ w.T + b
        if i + 1 < len(layers):
            x = x * torch.sigmoid(x)
    return x


def observation_stats(obs):
    """Mean and population std (held in ``STD_RANGE``) over every leading
    dim: running statistics started from none and fed this one batch."""
    flat = obs.reshape(-1, obs.shape[-1])
    mean = flat.mean(0)
    std = (flat - mean).square().mean(0).sqrt().clamp(*STD_RANGE)
    return mean, std


def gaussian(logits):
    """(location, scale) of the pre-tanh Gaussian."""
    n = logits.shape[-1] // 2
    return logits[..., :n], softplus(logits[..., n:]) + MIN_SCALE


def log_prob(logits, u):
    """Log density of the action tanh(u), from its pre-tanh value u."""
    loc, scale = gaussian(logits)
    z = (u - loc) / scale
    return (-0.5 * z * z - torch.log(scale) - HALF_LOG_2PI - log_dtanh(u)).sum(-1)


def entropy_estimate(logits, eps):
    """One-sample estimate of the squashed Gaussian's entropy at the draw
    loc + scale * eps."""
    loc, scale = gaussian(logits)
    x = loc + scale * eps
    return (0.5 + HALF_LOG_2PI + torch.log(scale) + log_dtanh(x)).sum(-1)


def gae(reward, value, last_value, termination, truncation, gamma, lam):
    """Time-major (T, B): (value targets, policy advantages)."""
    live, keep = 1.0 - termination, 1.0 - truncation
    after = torch.cat([value[1:], last_value[None]])
    delta = (reward + gamma * live * after - value) * keep
    acc = torch.zeros_like(last_value)
    out = []
    for t in range(reward.shape[0] - 1, -1, -1):
        acc = delta[t] + gamma * lam * live[t] * keep[t] * acc
        out.append(acc)
    target = torch.stack(out[::-1]) + value
    target_after = torch.cat([target[1:], last_value[None]])
    return target, (reward + gamma * live * target_after - value) * keep


def ppo_loss(policy: Layers, value: Layers, stats, batch: Dict, ent_eps, cfg) -> torch.Tensor:
    """The loss of one minibatch; ``batch`` holds rows x time (B, T, ...),
    ``stats`` the observation (mean, std) or None, ``ent_eps`` (B, T, A)."""
    norm = (lambda o: o) if stats is None else (lambda o: (o - stats[0]) / stats[1])
    tm = lambda x: x.transpose(0, 1)
    obs = norm(tm(batch["observation"]))
    logits = mlp(policy, obs)
    v = mlp(value, obs)[..., 0]
    v_last = mlp(value, norm(batch["next_observation"][:, -1]))[..., 0]
    truncation = tm(batch["truncation"])
    termination = (1.0 - tm(batch["discount"])) * (1.0 - truncation)
    with torch.no_grad():
        target, adv = gae(tm(batch["reward"]) * cfg["reward_scaling"], v, v_last, termination,
                          truncation, cfg["discounting"], cfg["gae_lambda"])
        if cfg["normalize_advantage"]:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ratio = torch.exp(log_prob(logits, tm(batch["raw_action"])) - tm(batch["log_prob"]))
    eps = cfg["clipping_epsilon"]
    surrogate = torch.minimum(ratio * adv, ratio.clamp(1.0 - eps, 1.0 + eps) * adv)
    return (-surrogate.mean() + 0.25 * (target - v).square().mean()
            - cfg["entropy_cost"] * entropy_estimate(logits, tm(ent_eps)).mean())


def learn(policy: Layers, value: Layers, stats, minibatches: List[Dict], ent_eps, cfg):
    """Adam steps, one per minibatch, from the given weights. Returns (the
    losses, the first step's gradient, each leaf's change after the last
    step), the leaves in the order policy then value, each W then b."""
    leaves = [t.detach().clone().requires_grad_(True)
              for layers in (policy, value) for w, b in layers for t in (w, b)]
    n_pol = 2 * len(policy)
    pairs = lambda ts: [(ts[i], ts[i + 1]) for i in range(0, len(ts), 2)]
    start = [t.detach().clone() for t in leaves]
    m = [torch.zeros_like(t) for t in leaves]
    s = [torch.zeros_like(t) for t in leaves]
    losses, first = [], None
    for k, batch in enumerate(minibatches):
        loss = ppo_loss(pairs(leaves[:n_pol]), pairs(leaves[n_pol:]), stats, batch, ent_eps[k],
                        cfg)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.detach())
        first = [g.detach() for g in grads] if first is None else first
        step = k + 1
        with torch.no_grad():
            for p, g, mk, sk in zip(leaves, grads, m, s):
                mk.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
                sk.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
                m_hat = mk / (1.0 - ADAM_B1 ** step)
                s_hat = sk / (1.0 - ADAM_B2 ** step)
                p.sub_(cfg["learning_rate"] * m_hat / (s_hat.sqrt() + ADAM_EPS))
    return losses, first, [p.detach() - q for p, q in zip(leaves, start)]
