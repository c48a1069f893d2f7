"""Nodes of the CUDA graph that the window replays: the encoder's fused
PCM-to-bytes step, ("bytes", nbytes). A count that repeats exactly; none
without a card or such a step."""


def read(run):
    step = run.coder.steps.get(("bytes", run.cfg["nbytes"])) if run.on_card else None
    return None if step is None else float(sum(step.node_counts()))
