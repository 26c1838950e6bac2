"""Device operations (kernels, copies, memsets) a batch in the profiled
slice: the port's kernels and PyTorch's glue alike."""


def read(run):
    t = run.trace
    return len(t.ops) / t.n_calls if t is not None and t.n_calls else None
