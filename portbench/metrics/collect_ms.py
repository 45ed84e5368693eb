"""Milliseconds of the collect half (``rollout_step``: the policy MLP, the
action noise and the env's control step, with the normalizer's update) per
control step, host clock from a synchronize to a synchronize, over the
unprofiled traced steps."""


def read(run):
    spans = run.host_spans["collect"]
    if not spans:
        return None
    g = run.geometry
    return 1e3 * sum(spans) / (len(spans) * g.n_unrolls * g.unroll)
