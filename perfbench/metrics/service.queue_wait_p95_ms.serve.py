"""95th percentile (nearest rank) of the time a served query waited in
the queue, from submit to taking a slot (the service's
``stats()["waits"]``)."""

from perfbench import ranges


def read(run):
    return ranges.wait_ms(run, "queue_p95_ms")
