"""Launch calls the host made a frame in the traced stretch (kernels,
graph replays, memsets and copies: a replayed tile is one): the frame
session's and the frame graphs' host work
(``occ_render.OccupancyFrameSession``, ``render.render_frame``,
``frame_graph.FrameGraphs``)."""


def read(run):
    summary, frames = run["trace"], run["window"].get("trace_frames")
    if not summary or not frames:
        return None
    return summary["host_launches"] / frames
