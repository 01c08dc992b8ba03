"""Asset import (OBJ/MTL, textures), image output and checkpoints."""

from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["load_checkpoint", "save_checkpoint"]
