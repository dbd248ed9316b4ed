"""Assigned input-shape sets, verbatim from the task spec.

Every (arch × shape) pair is one dry-run/roofline cell; kinds decide which
step gets lowered ('train' -> train_step, 'prefill'/'decode'/'serve'/
'retrieval' -> the serving path).
"""

from __future__ import annotations

import dataclasses

__all__ = ["LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "ShapeSpec",
           "shape_table"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                    # train | prefill | decode | serve | retrieval
    params: dict


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            dict(seq_len=32768, global_batch=128)),
    # decode shape: 1 new token against a 512k cache (cost O(cache));
    # a 500k *prefill* would be quadratic and is out of scope for the
    # full-attention archs — see DESIGN.md §5.
    "long_500k": ShapeSpec("long_500k", "decode",
                           dict(seq_len=524288, global_batch=1)),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train",
        dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
             fanout=(15, 10), d_feat=602, n_classes=41)),
    "ogb_products": ShapeSpec(
        "ogb_products", "train",
        dict(n_nodes=2449029, n_edges=61859140, d_feat=100, n_classes=47)),
    "molecule": ShapeSpec(
        "molecule", "train",
        dict(n_nodes=30, n_edges=64, batch=128)),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}


def shape_table(family: str) -> dict[str, ShapeSpec]:
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
            "recsys": RECSYS_SHAPES}[family]
