"""The port's PPO trainer, ``agents/ppo/train.py::train``, on a batched 2-D
point mass (tests/test_ppo.py's), float64 on the CPU, with no JAX
reference (one training step against the JAX package's pieces:
tests/test_torch_ppo_train.py): it learns; ``training/sps`` counts each
reset's steps once; a checkpoint round trips and resumes; zero timesteps
return the initial params; its errors (on checkpoints the JAX package
writes, too).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import torch_one_thread  # noqa: F401
from brax_tracking_tpu.agents.ppo import losses as jlosses
from brax_tracking_tpu.agents.ppo import networks as jnetworks
from brax_tracking_tpu.training import checkpoint as jcheckpoint
from brax_tracking_tpu.training import running_statistics as jrs
from brax_tracking_tpu_torch.agents.ppo import networks as tnetworks
from brax_tracking_tpu_torch.agents.ppo import train as ttrain
from brax_tracking_tpu_torch.envs.base import Env, State
from brax_tracking_tpu_torch.training import checkpoint as tcheckpoint
from brax_tracking_tpu_torch.training import gradients as tgradients
from brax_tracking_tpu_torch.training import running_statistics as trs


# --- the port's trainer (no JAX reference) ------------------------------------


@dataclasses.dataclass
class _Pos:
    pos: torch.Tensor

    def tensors(self):
        return {"pos": self.pos}

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


class PointMass(Env):
    """2-D point mass steering to the origin, batched (tests/test_ppo.py's)."""

    def reset(self, generator, batch_size):
        pos = 2.0 * torch.rand(batch_size, 2, generator=generator, dtype=torch.float64) - 1.0
        return self._state(pos, {})

    def _state(self, pos, metrics):
        dist = torch.linalg.norm(pos, dim=-1)
        return State(pipeline_state=_Pos(pos), obs=pos, reward=-dist,
                     done=torch.zeros_like(dist), metrics={**metrics, "distance": dist}, info={})

    def step(self, state, action):
        s = self._state(state.pipeline_state.pos + 0.1 * torch.clamp(action, -1.0, 1.0),
                        state.metrics)
        return state.replace(pipeline_state=s.pipeline_state, obs=s.obs, reward=s.reward,
                             done=s.done, metrics=s.metrics)

    @property
    def observation_size(self):
        return 2

    @property
    def action_size(self):
        return 2


PM_ARGS = dict(episode_length=32, num_envs=64, learning_rate=3e-4, entropy_cost=1e-3,
               discounting=0.95, unroll_length=8, batch_size=64, num_minibatches=4,
               num_updates_per_batch=4, num_eval_envs=64, normalize_observations=True, seed=0,
               device="cpu")


def test_train_learns_point_mass():
    """tests/test_ppo.py's run: a random policy scores ~ -32 * 0.6."""
    evals = []
    _, (normalizer, policy), metrics = ttrain.train(
        PointMass(), num_timesteps=2 ** 15, num_evals=3,
        progress_fn=lambda step, m: evals.append((step, m["eval/episode_reward"])), **PM_ARGS)
    assert [s for s, _ in evals] == [0, 2 ** 14, 2 ** 15]
    assert evals[-1][1] > evals[0][1] + 5.0, evals
    assert metrics["eval/episode_reward"] > -12.0, metrics
    assert metrics["eval/avg_episode_length"] == 32
    for k in ("eval/episode_reward_std", "eval/episode_distance", "eval/epoch_eval_time",
              "eval/sps", "eval/walltime", "training/sps", "training/total_loss",
              "training/policy_loss", "training/v_loss", "training/entropy_loss"):
        assert np.isfinite(metrics[k]), k
    assert float(normalizer.count) == 2 ** 15


class _Clock:
    """A host clock that advances ``tick`` seconds per reading."""

    def __init__(self, tick):
        self.t, self.tick = 0.0, tick

    def perf_counter(self):
        self.t += self.tick
        return self.t


def test_training_sps_counts_each_reset_once(monkeypatch):
    """With 2 resets per eval, each epoch call reports its own steps over its
    own time; the JAX package multiplies by the resets too (ROADMAP C)."""
    monkeypatch.setattr(ttrain, "time", _Clock(0.5))
    seen = []
    ttrain.train(PointMass(), num_timesteps=2 * 2048, num_evals=2, num_resets_per_eval=2,
                 progress_fn=lambda step, m: seen.append((step, m)), **PM_ARGS)
    step, m = seen[-1]
    assert step == 2 * 2048
    # one training step of 4 * 64 * 8 env steps per epoch call, 0.5 s apart
    assert m["training/sps"] == 2048 / 0.5


def _state_tensors(state):
    out = {f"params.{k}": v for k, v in state.params.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"adam.{i}.{k}": v for k, v in s.items()})
    out.update({f"normalizer.{k}": v for k, v in
                dataclasses.asdict(state.normalizer_params).items()})
    return out


def test_checkpoint_round_trip_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _, (normalizer, policy), _ = ttrain.train(PointMass(), num_timesteps=4096, num_evals=2,
                                              checkpoint_dir=ckpt, **PM_ARGS)
    path = tcheckpoint.latest_checkpoint(ckpt)
    assert path.endswith("4096") and tcheckpoint.checkpoint_layout(path) == "full"
    assert tcheckpoint.latest_checkpoint(str(tmp_path / "missing")) is None

    def fresh(seed):
        gen = torch.Generator().manual_seed(seed)
        net = tnetworks.make_ppo_networks(2, 2, generator=gen, device="cpu")
        return ttrain.TrainingState(
            params=net, optimizer=tgradients.make_optimizer(net.parameters(), 3e-4),
            normalizer_params=trs.init_state(torch.zeros(2, dtype=torch.float64)), env_steps=0)

    restored = tcheckpoint.restore_checkpoint(path, fresh(1))
    assert restored.env_steps == 4096
    # the restored policy is the trained one, bitwise
    for a, b in zip(restored.params.policy.parameters(), policy.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(restored.normalizer_params.mean, normalizer.mean)
    # save what was restored, restore it into another fresh state: every
    # tensor bitwise, the Adam step included
    tcheckpoint.save_checkpoint(str(tmp_path / "again"), restored)
    again = tcheckpoint.restore_checkpoint(str(tmp_path / "again"), fresh(2))
    a, b = _state_tensors(restored), _state_tensors(again)
    assert a.keys() == b.keys() and any(k.endswith(".step") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert again.env_steps == 4096

    # resume: the run continues from the restored step count
    seen = []
    ttrain.train(PointMass(), num_timesteps=4096, num_evals=2, restore_checkpoint_path=path,
                 progress_fn=lambda step, m: seen.append(step), **PM_ARGS)
    assert seen == [4096, 8192]

    # pickled params (brax.io.model parity)
    tcheckpoint.save_params(str(tmp_path / "params.pkl"), (normalizer, policy))
    nrm, pol = tcheckpoint.load_params(str(tmp_path / "params.pkl"))
    np.testing.assert_array_equal(nrm["mean"], normalizer.mean.numpy())
    for p, layer in zip(pol, policy.layers):
        np.testing.assert_array_equal(p["kernel"], layer.weight.detach().numpy().T)


def test_train_zero_timesteps_returns_init():
    make_policy, (normalizer, policy), metrics = ttrain.train(PointMass(), num_timesteps=0,
                                                              **PM_ARGS)
    assert metrics == {} and float(normalizer.count) == 0
    act, extras = make_policy((normalizer, policy), deterministic=True)(
        torch.zeros(3, 2, dtype=torch.float64), None)
    assert act.shape == (3, 2) and extras == {}


def test_errors(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="divide by num_envs"):
        ttrain.train(PointMass(), num_timesteps=64, **dict(PM_ARGS, num_envs=48))
    # a bfloat16 compute dtype (ROADMAP A.15, ported): the params stay
    # float64, the outputs come back in the input's dtype
    bf16 = tnetworks.make_ppo_networks(2, 2, compute_dtype=torch.bfloat16,
                                       generator=torch.Generator(), device="cpu")
    assert bf16.compute_dtype == torch.bfloat16
    assert {p.dtype for p in bf16.parameters()} == {torch.float64}
    out = bf16.policy_logits(None, torch.ones(3, 2, dtype=torch.float64))
    assert out.dtype == torch.float64 and out.shape == (3, 4)
    # per-env models need a physics model (their tests:
    # test_torch_randomize.py)
    with pytest.raises(TypeError, match="physics model"):
        ttrain.train(PointMass(), num_timesteps=64,
                     randomization_fn=lambda m, num_envs, generator: (m, ()), **PM_ARGS)
    # an orbax checkpoint of the JAX package (ROADMAP A.13, ported) restores
    # where its tree is a training state; another tree raises naming why
    # (the restores themselves: tests/test_torch_orbax.py)
    orbax_dir = str(tmp_path / "orbax" / "100")
    jcheckpoint.save_checkpoint(orbax_dir, {"x": jnp.ones(3)})
    assert tcheckpoint.checkpoint_layout(orbax_dir) == "unknown"
    with pytest.raises(ValueError, match="neither"):
        ttrain.train(PointMass(), num_timesteps=2048, restore_checkpoint_path=orbax_dir,
                     **PM_ARGS)
    ref_dir = str(tmp_path / "orbax" / "reference")
    jnet = lambda k, out: jnetworks.init_mlp(k, (256, 256, out), 2, jnp.float64)
    jcheckpoint.save_checkpoint(ref_dir, (jrs.init_state(jnp.ones((2,), jnp.float64)),
                                          jlosses.PPONetworkParams(
                                              policy=jnet(jax.random.PRNGKey(0), 4),
                                              value=jnet(jax.random.PRNGKey(1), 1))))
    assert tcheckpoint.checkpoint_layout(ref_dir) == "reference"
    seen = []
    ttrain.train(PointMass(), num_timesteps=2048, num_evals=2, restore_checkpoint_path=ref_dir,
                 progress_fn=lambda step, m: seen.append(step), **PM_ARGS)
    assert seen == [0, 2048]
    # the default device is the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {k: v for k, v in PM_ARGS.items() if k != "device"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train(PointMass(), num_timesteps=64, **args)
