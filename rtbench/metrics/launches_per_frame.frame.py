"""Device operations a lit frame (kernels, copies and fills) in the
torch.profiler trace of the traced steps, present included."""


def read(obs):
    if (obs.pathtrace or obs.traced is None or obs.traced.steps <= 0
            or not obs.traced.device_ops):
        return None
    return len(obs.traced.device_ops) / obs.traced.steps
