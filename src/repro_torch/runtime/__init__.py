"""Runtime fault handling (the port has ``StragglerStats`` so far)."""
