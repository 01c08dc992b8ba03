"""What a traced run observed, as the per-layer readers take it.

The readers (rtbench/metrics/<name>.py) read only this object: the
cell's own sizes, the harness's spans around the program's entry, the
torch.profiler trace of a few steps, and the host syncs counted over a
few more. A reader returns None where it finds nothing to read.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

from .trace import Traced


@dataclass
class Obs:
    cell: object  # harness.Cell
    render_ms: List[float] = field(default_factory=list)  # a span a step
    window_s: float = 0.0  # the window's wall time on the host clock
    window_frames: int = 0  # frames presented in the window
    window_samples: int = 0  # path-tracing samples the window added
    traced: Optional[Traced] = None
    traced_samples: int = 0
    syncs: int = 0
    sync_samples: int = 0

    @property
    def pathtrace(self) -> bool:
        return int(self.cell.traffic.get("pt_bounces", 0)) > 0

    def shape(self) -> dict:
        """The cell's sizes, from its configuration and mix alone;
        "faces" is what the sweeps take: an instanced configuration's
        whole soup ("instanced_faces"), else its mesh's "faces"."""
        tr, cfg = self.cell.traffic, self.cell.config
        return {"width": tr["width"], "height": tr["height"],
                "faces": cfg.get("instanced_faces", cfg["faces"]),
                "spheres": len(cfg["scene"].get("spheres", ())),
                "bounces": int(tr.get("pt_bounces", 0))}

    def device_us(self, kernel: str) -> float:
        """Device time of the traced operations named `kernel` (the CUDA
        function's name, with or without its signature or template)."""
        pat = re.compile(r"(^|[\s:*&])" + re.escape(kernel) + r"($|[<(\s])")
        return sum(e - s for name, s, e in self.traced.device_ops
                   if pat.search(name))
