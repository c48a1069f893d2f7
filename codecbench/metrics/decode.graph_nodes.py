"""Nodes of the CUDA graph that the window replays: the decoder's fused
step with the concealed-frame count, ("stats", nbytes, 0). A count that
repeats exactly; none without a card or such a step."""


def read(run):
    step = run.coder.steps.get(("stats", run.cfg["nbytes"], 0)) if run.on_card else None
    return None if step is None else float(sum(step.node_counts()))
