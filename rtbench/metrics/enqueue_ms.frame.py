"""Host time of Renderer.render() a lit frame, less its waits on the
card: in the profiled steps, the harness's span around the program's
entry less the CUDA runtime calls inside it that may wait for the device
(trace.WAITS), per step. The profiler's own cost per operation is in it."""


def read(obs):
    if obs.pathtrace or obs.traced is None or obs.traced.steps <= 0:
        return None
    length, waiting = obs.traced.span_us("rtbench.render")
    if length <= 0:
        return None
    return (length - waiting) / 1e3 / obs.traced.steps
