"""Host time a training step spent in the train loop and its step graphs
(``train.OccupancyTrainLoop`` / ``train.TrainLoop``, ``step_graph``): the
benchmark's span around ``step_auto_many``, over the steps of the window
outside the traced stretch.  Where it nears the step's time, the host sets
the pace."""


def read(run):
    spans = run["window"].get("spans")
    if not spans or not spans["steps"]:
        return None
    return spans["train_host_s"] / spans["steps"] * 1e3
