"""Share of kernel K9's roofline: its least time at the published peaks
(rtbench/roofline/K9.py, rtbench/peaks.json) over its device time in
the trace, per frame or per sample."""

from rtbench.roofline import K9, share


def read(obs):
    return share(obs, K9)
