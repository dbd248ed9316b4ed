"""In-edge slots the backend's kernel pulls read (``pull_edges``), per
served query completed: a narrow batch pays a whole scan a step."""

from perfbench import ranges


def read(run):
    return ranges.pull_edges_per_query(run)
