"""kimi-k2-1t-a32b [arXiv:2501.kimi2, paper-table] (the port's copy of
repro.configs.kimi_k2_1t_a32b).

61L d_model=7168 64H (GQA kv=8, head_dim=112) vocab=163840,
MoE: 384 routed experts top-8 (d_expert=2048) + 1 shared expert.
~1.03T total params / ~32B active, about 2 TB in bf16: nothing of it
fits one H100 (ROADMAP.md queue 1, item 9); it runs reduced on the CPU.
Optimizer: adafactor (factored second moments).
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, TransformerConfig

MODEL = TransformerConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840,
    n_experts=384, n_shared_experts=1, top_k=8, d_expert=2048,
    qkv_bias=False, rope_theta=50_000.0, tie_embeddings=False,
    act="silu", remat="full", attn_chunk=256,
    # the JAX package's 16-way model axis (inert on one device)
    sharding_overrides=(("cache_head_dim", "model"),),
)

ARCH = ArchSpec(
    arch_id="kimi-k2-1t-a32b", family="lm", model=MODEL, shapes=LM_SHAPES,
    source="arXiv:2501.kimi2", optimizer="adafactor",
    skipped_shapes=(
        ("long_500k",
         "pure full-attention arch; long_500k runs only for "
         "sub-quadratic/hybrid attention per assignment"),
    ),
)
