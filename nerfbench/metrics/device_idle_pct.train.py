"""The share of the traced stretch in which no operation ran on the card
(kernels, copies, memsets): 100 * (1 - busy / stretch)."""


def read(run):
    summary, seconds = run["trace"], run["window"].get("trace_window_s")
    if not summary or not seconds:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / seconds)
