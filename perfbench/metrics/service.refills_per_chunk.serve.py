"""Queries admitted into freed slots of a running batch, per chunk."""

from perfbench import reduce


def read(run):
    return reduce.refills_per_chunk(run)
