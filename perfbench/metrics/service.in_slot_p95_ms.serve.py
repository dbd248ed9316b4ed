"""95th percentile (nearest rank) of the time a served query held its
slot, from taking it to its result (the service's ``stats()["waits"]``)."""

from perfbench import ranges


def read(run):
    return ranges.wait_ms(run, "in_slot_p95_ms")
