"""Runtime: the Renderer."""
