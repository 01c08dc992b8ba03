"""CUDA launch calls a lit frame under the program's span "frame.refit"
(the per-frame refit of an instanced scene) in the profiled steps
(rtbench.spans.launches_by_span: each call under the innermost program
span that holds its start). None where the trace holds no such span."""

from rtbench.spans import launches_by_span


def read(obs):
    if (obs.pathtrace or obs.traced is None or obs.traced.steps <= 0
            or not obs.traced.device_ops):
        return None
    return launches_by_span(obs.traced).get("frame.refit") or None
