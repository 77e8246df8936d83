"""Entry points of the port for prefill and serving."""
