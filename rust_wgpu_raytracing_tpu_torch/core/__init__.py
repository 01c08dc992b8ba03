"""Host-side core: camera, controllers and scene assembly."""
