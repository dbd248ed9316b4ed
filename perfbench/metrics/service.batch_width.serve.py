"""Mean width the service starts a batch with (``service.batch_start``
events)."""

from perfbench import reduce


def read(run):
    return reduce.batch_width(run)
