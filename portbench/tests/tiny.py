"""A cell cut to a size the CPU runs in seconds: 8 envs, unrolls of 4,
4 minibatches of 2 rows, 2 passes; everything else as the cell has it."""

from portbench import harness


def tiny_cell(name, **traffic_changes):
    bench, entry, traffic, config = harness.load_cell(name)
    config = dict(config, batch_size=2, num_updates_per_batch=2, unroll_length=4)
    traffic = dict(traffic, num_envs=8, num_minibatches=4, check=dict(env_sample=8, policy_rows=8),
                   span_steps=1, trace_steps=1, **traffic_changes)
    return bench, entry, traffic, config
