"""Launch drivers of the port: the static-batch serving driver (`serve`)."""
