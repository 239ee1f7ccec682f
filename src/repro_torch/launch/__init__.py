"""Launch entry points of the port: the static-batch `serve` and the
continuous-batching engine (`engine`, `serve.serve_continuous`)."""
