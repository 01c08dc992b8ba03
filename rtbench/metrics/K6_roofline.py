"""Share of kernel K6's roofline: its least time at the published peaks
(rtbench/roofline/K6.py, rtbench/peaks.json) over its device time in
the trace, per frame or per sample."""

from rtbench.roofline import K6, share


def read(obs):
    return share(obs, K6)
