"""Milliseconds of the learner half (``learn_step``: 16 SGD passes over the
rows in minibatches, autograd and Adam) per training step, host clock from a
synchronize to a synchronize, mean over the unprofiled traced steps."""


def read(run):
    spans = run.host_spans["learn"]
    return 1e3 * sum(spans) / len(spans) if spans else None
