"""The 10 assigned architecture configs (port of
``repro.configs.archs``), with the reference's values.

One builder per arch id returning the exact full config, plus a reduced
smoke config of the same family for CPU tests.
"""

from __future__ import annotations

from ..models.gnn import GNNConfig
from ..models.moe import MoEConfig
from ..models.recsys import XDeepFMConfig
from ..models.transformer import TransformerConfig

__all__ = ["ARCH_FAMILY", "ALL_ARCHS", "PORTED_ARCHS", "full_config",
           "smoke_config"]

ARCH_FAMILY = {
    "llama3.2-1b": "lm",
    "qwen1.5-32b": "lm",
    "gemma2-9b": "lm",
    "moonshot-v1-16b-a3b": "lm",
    "deepseek-moe-16b": "lm",
    "egnn": "gnn",
    "gin-tu": "gnn",
    "graphsage-reddit": "gnn",
    "graphcast": "gnn",
    "xdeepfm": "recsys",
}
ALL_ARCHS = list(ARCH_FAMILY)
PORTED_ARCHS = tuple(ALL_ARCHS)


def full_config(arch: str):
    if arch == "llama3.2-1b":
        # 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256
        return TransformerConfig(
            name=arch, n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
            d_ff=8192, vocab=128256, rope_theta=500000.0)
    if arch == "qwen1.5-32b":
        # 64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064, QKV bias
        return TransformerConfig(
            name=arch, n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
            d_ff=27392, vocab=152064, qkv_bias=True, rope_theta=1000000.0)
    if arch == "gemma2-9b":
        # 42L d_model=3584 16H (kv=8) d_ff=14336 vocab=256000,
        # local(4096)+global alternating, logit softcaps, head_dim=256
        return TransformerConfig(
            name=arch, n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
            d_ff=14336, vocab=256000, head_dim=256, local_window=4096,
            attn_softcap=50.0, final_softcap=30.0, embed_scale=True,
            rope_theta=10000.0)
    if arch == "moonshot-v1-16b-a3b":
        # 48L d_model=2048 16H (kv=16) d_ff=1408 vocab=163840, MoE 64e top-6
        return TransformerConfig(
            name=arch, n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
            d_ff=1408, vocab=163840,
            moe=MoEConfig(d_model=2048, d_ff_expert=1408, n_experts=64,
                          top_k=6, n_shared=2, dispatch="pull"))
    if arch == "deepseek-moe-16b":
        # 28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400,
        # 2 shared + 64 routed top-6 (fine-grained)
        return TransformerConfig(
            name=arch, n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
            d_ff=1408, vocab=102400,
            moe=MoEConfig(d_model=2048, d_ff_expert=1408, n_experts=64,
                          top_k=6, n_shared=2, dispatch="pull"))
    if arch == "egnn":
        return GNNConfig(arch=arch, n_layers=4, d_hidden=64,
                         d_in=0, d_out=0)        # d_in/out set per shape
    if arch == "gin-tu":
        return GNNConfig(arch=arch, n_layers=5, d_hidden=64,
                         d_in=0, d_out=0, aggregator="sum")
    if arch == "graphsage-reddit":
        return GNNConfig(arch=arch, n_layers=2, d_hidden=128,
                         d_in=0, d_out=0, aggregator="mean",
                         fanouts=(25, 10))
    if arch == "graphcast":
        return GNNConfig(arch=arch, n_layers=16, d_hidden=512,
                         d_in=0, d_out=0, n_vars=227)
    if arch == "xdeepfm":
        # vocab per field: 2^20 (Criteo scale; a power of two so the
        # row-sharded tables divide every mesh)
        return XDeepFMConfig(n_fields=39, vocab_per_field=1 << 20,
                             embed_dim=10, cin_layers=(200, 200, 200),
                             mlp_dims=(400, 400))
    raise KeyError(arch)


def smoke_config(arch: str):
    """Reduced same-family config: runs a CPU forward/train step."""
    if arch == "llama3.2-1b":
        return TransformerConfig(
            name=arch + "-smoke", n_layers=2, d_model=64, n_heads=8,
            n_kv_heads=2, d_ff=128, vocab=256, dtype="float32",
            loss_chunk=32, attn_impl="naive")
    if arch == "qwen1.5-32b":
        return TransformerConfig(
            name=arch + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=160, vocab=256, qkv_bias=True,
            dtype="float32", loss_chunk=32, attn_impl="naive")
    if arch == "gemma2-9b":
        return TransformerConfig(
            name=arch + "-smoke", n_layers=4, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=256, head_dim=32, local_window=8,
            attn_softcap=50.0, final_softcap=30.0, embed_scale=True,
            dtype="float32", loss_chunk=32, attn_impl="naive")
    if arch in ("moonshot-v1-16b-a3b", "deepseek-moe-16b"):
        return TransformerConfig(
            name=arch + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=96, vocab=256, dtype="float32",
            loss_chunk=32, attn_impl="naive",
            moe=MoEConfig(d_model=64, d_ff_expert=96, n_experts=8, top_k=2,
                          n_shared=2, dispatch="pull"))
    if arch == "egnn":
        return GNNConfig(arch=arch, n_layers=2, d_hidden=16, d_in=8,
                         d_out=4)
    if arch == "gin-tu":
        return GNNConfig(arch=arch, n_layers=2, d_hidden=16, d_in=8,
                         d_out=4)
    if arch == "graphsage-reddit":
        return GNNConfig(arch=arch, n_layers=2, d_hidden=16, d_in=8,
                         d_out=4, fanouts=(5, 3))
    if arch == "graphcast":
        return GNNConfig(arch=arch, n_layers=2, d_hidden=16, d_in=0,
                         d_out=0, n_vars=9)
    if arch == "xdeepfm":
        return XDeepFMConfig(n_fields=7, vocab_per_field=64, embed_dim=6,
                             cin_layers=(8, 8), mlp_dims=(16, 16))
    raise KeyError(arch)
