"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B] (the port's copy of
repro.configs.qwen2_moe_a2_7b).

24L d_model=2048 16H (GQA kv=16 => MHA) d_ff=1408 vocab=151936,
MoE: 60 routed experts top-4 + 4 shared experts (shared ffn = 4*1408=5632).
Experts pad 60 -> 64 (models/transformer.EXPERT_PAD_TO), as in the JAX
package, so weights carry across. About 15.1B parameters, 30.3 GB in
bf16: one H100 serves it; its adam state would not fit.
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, TransformerConfig

MODEL = TransformerConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151936,
    n_experts=60, n_shared_experts=4, top_k=4, d_expert=1408,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=False,
    act="silu", remat="full",
)

ARCH = ArchSpec(
    arch_id="qwen2-moe-a2.7b", family="lm", model=MODEL, shapes=LM_SHAPES,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B", optimizer="adam",
    skipped_shapes=(
        ("long_500k",
         "pure full-attention arch; long_500k runs only for "
         "sub-quadratic/hybrid attention per assignment"),
    ),
)
