"""Host time of the per-frame refit of an instanced scene a lit frame,
less its waits on the card: in the profiled steps, the program's span
"frame.refit" (Renderer.render, before the frame program; "rt.frame.refit"
in the trace) less the CUDA runtime calls inside it that may wait for
the device (trace.WAITS), per step. None where the program has no such
span: a plain scene, or a program without instancing on Renderer's path."""


def read(obs):
    if obs.pathtrace or obs.traced is None or obs.traced.steps <= 0:
        return None
    length, waiting = obs.traced.span_us("rt.frame.refit")
    if length <= 0:
        return None
    return (length - waiting) / 1e3 / obs.traced.steps
