"""Share of kernel K4's roofline: its least time at the published peaks
(rtbench/roofline/K4.py, rtbench/peaks.json) over its device time in
the trace, per frame or per sample."""

from rtbench.roofline import K4, share


def read(obs):
    return share(obs, K4)
