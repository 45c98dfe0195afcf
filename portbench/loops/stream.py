"""One client, closed loop, each request streamed: the client takes its
audio a chunk at a time and sends the next request once the last chunk has
come. Units, the traced part and the tally are the closed loop's."""

from .closed import tally, traced_enough, units  # noqa: F401

SERVES = "serve_stream"
