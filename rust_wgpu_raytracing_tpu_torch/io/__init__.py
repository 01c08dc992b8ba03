"""Asset import (OBJ/MTL, textures) and image output."""
