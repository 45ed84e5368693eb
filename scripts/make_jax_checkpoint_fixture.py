"""Writes the JAX orbax checkpoint fixtures the port restores without orbax.

    python scripts/make_jax_checkpoint_fixture.py [--out DIR]

Needs JAX, optax and orbax (the development machine has them; the card's
machine does not, which is why the fixtures are committed). Into ``DIR``
(default ``brax_tracking_tpu_torch/assets/jax_checkpoints``) it writes, with the JAX
package's own ``training/checkpoint.py::save_checkpoint``:

- ``rodent/``: a JAX ``TrainingState`` at the flagship
  ``train_rodent`` widths (policy and value MLPs 256 x 256) and the rodent
  stand-in env's observation and action sizes (``rodent_single_clip`` on
  ``builtin:rodent_standin.xml``, sizes read from the port's env): params
  from ``init_mlp`` (float32), three Adam updates on seeded gradients (so
  both moments and ``count`` are non-zero), a normalizer updated on a
  seeded batch, and ``env_steps`` 131072;
- ``rodent_reference/``: the reference's bare ``(normalizer,
  params)`` tuple of the same state;
- ``rodent.npz``: every array of the full state, keyed by its
  dotted orbax key (``params.policy.0.kernel``, ``optimizer_state.0.count``,
  ``normalizer_params.mean``, ``env_steps``, ...); the reference fixture
  holds the same normalizer and params.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HIDDEN = (256, 256)
ENV_STEPS = 131072
RODENT_ARGV = ["train=train_rodent", "dataset=rodent",
               "dataset.env_args.mjcf_path=builtin:rodent_standin.xml"]


def rodent_sizes():
    """(observation size, action size) of the flagship env on the stand-in."""
    import torch

    from brax_tracking_tpu_torch.harness import config as hc
    from brax_tracking_tpu_torch.harness import driver

    with tempfile.TemporaryDirectory() as tmp:
        cfg = hc.load_config(RODENT_ARGV + [f"paths.data_dir={tmp}"])
        env = driver.build_env_from_cfg(cfg, "cpu", torch.float32)
    state = env.reset(torch.Generator().manual_seed(0), 1)
    return int(state.obs.shape[-1]), int(env.action_size)


def flat(tree, prefix=""):
    """{dotted key: numpy array} of a pytree of dicts, lists and tuples."""
    import numpy as np

    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}.{k}" if prefix else k))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "brax_tracking_tpu_torch", "assets",
                                                      "jax_checkpoints"))
    args = parser.parse_args(argv)

    obs_size, action_size = rodent_sizes()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax

    from brax_tracking_tpu.agents.ppo import losses, networks
    from brax_tracking_tpu.agents.ppo import train as jtrain
    from brax_tracking_tpu.training import checkpoint, running_statistics

    params = losses.PPONetworkParams(
        policy=networks.init_mlp(jax.random.PRNGKey(1), HIDDEN + (2 * action_size,), obs_size),
        value=networks.init_mlp(jax.random.PRNGKey(2), HIDDEN + (1,), obs_size),
    )
    optimizer = optax.adam(3e-4)
    opt_state = optimizer.init(params)
    key = jax.random.PRNGKey(3)
    for _ in range(3):
        leaves, treedef = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(key, len(leaves) + 1)
        key = keys[0]
        grads = jax.tree_util.tree_unflatten(treedef, [
            0.01 * jax.random.normal(k, x.shape, x.dtype) for k, x in zip(keys[1:], leaves)])
        updates, opt_state = optimizer.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
    normalizer = running_statistics.update(
        running_statistics.init_state(jnp.zeros((obs_size,), jnp.float32)),
        0.3 + 2.0 * jax.random.normal(jax.random.PRNGKey(4), (256, obs_size), jnp.float32))
    state = jtrain.TrainingState(optimizer_state=opt_state, params=params,
                                 normalizer_params=normalizer,
                                 env_steps=jnp.asarray(ENV_STEPS, jnp.int32))

    os.makedirs(args.out, exist_ok=True)
    full = os.path.join(args.out, "rodent")
    reference = os.path.join(args.out, "rodent_reference")
    for d in (full, reference):
        shutil.rmtree(d, ignore_errors=True)
    checkpoint.save_checkpoint(full, state)
    checkpoint.save_checkpoint(reference, (normalizer, params))
    host = jax.device_get(state)
    nets = lambda p: {"policy": p.policy, "value": p.value}
    adam = host.optimizer_state[0]
    arrays = flat({"optimizer_state": [{"count": adam.count, "mu": nets(adam.mu),
                                        "nu": nets(adam.nu)}],
                   "params": nets(host.params),
                   "normalizer_params": {f: getattr(host.normalizer_params, f)
                                         for f in ("count", "mean", "summed_variance", "std")},
                   "env_steps": host.env_steps})
    np.savez(os.path.join(args.out, "rodent.npz"), **arrays)
    for d in (full, reference):
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)
        print(f"{d}: {size} bytes")
    print(f"{os.path.join(args.out, 'rodent.npz')}: "
          f"{os.path.getsize(os.path.join(args.out, 'rodent.npz'))} bytes, "
          f"{len(arrays)} arrays; obs {obs_size}, actions {action_size}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
