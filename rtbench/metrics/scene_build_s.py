"""Seconds of Scene.build in the Renderer's set-up (the OBJ import, the
packing and the LBVH): the program's span "setup.scene_build", whose
length it keeps in the counter "ns.setup.scene_build" with the recorder
on or off (runtime/profiler.timed). Read in a run on the card (its trace
holds device operations), as every metric of the benchmark."""

from rtbench.spans import program_counters


def read(obs):
    if obs.traced is None or not obs.traced.device_ops:
        return None
    ns = (program_counters() or {}).get("ns.setup.scene_build", 0)
    return ns / 1e9 if ns > 0 else None
