"""Host time a training step waited for its batch: the benchmark's span
around fetching each dispatch's batches from the data path
(``data.dataset``, ``data.shuffle``, ``data.prefetch``), over the steps of
the window outside the traced stretch."""


def read(run):
    spans = run["window"].get("spans")
    if not spans or not spans["steps"]:
        return None
    return spans["batch_wait_s"] / spans["steps"] * 1e3
