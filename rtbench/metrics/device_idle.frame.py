"""Share of a lit frame's time in which no device operation ran: 100 less
the device's busy time a step in the profiled steps (the union of the
operations' intervals) over the window's wall time a frame presented
(frame_ms of the same run, taken without the profiler, whose host cost
would lengthen the frame)."""


def read(obs):
    if (obs.pathtrace or obs.traced is None or obs.traced.steps <= 0
            or obs.window_frames <= 0 or not obs.traced.device_ops):
        return None
    busy = obs.traced.busy_us() / obs.traced.steps
    return 100.0 * (1.0 - busy / (obs.window_s * 1e6 / obs.window_frames))
