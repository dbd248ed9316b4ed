"""In-edge slots the backend's kernel pulls read (``pull_edges``), per
PPR query completed: a full scan reads all m each step."""

from perfbench import ranges


def read(run):
    return ranges.pull_edges_per_query(run)
