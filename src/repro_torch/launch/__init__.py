"""Entry points of the port's transformer path: the prefill and serve
steps and the ``serve`` CLI."""
