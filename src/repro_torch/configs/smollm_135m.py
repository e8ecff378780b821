"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small dense
(the port's copy of repro.configs.smollm_135m).

30L d_model=576 9H (GQA kv=3, head_dim=64) d_ff=1536 vocab=49152. On one
H100 it trains at train_4k's sequence of 4096 (134.5M parameters).
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, TransformerConfig

MODEL = TransformerConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab_size=49152,
    rope_theta=10_000.0, tie_embeddings=True, act="silu", remat="full",
    # the JAX package's 16-way model axis (inert on one device)
    sharding_overrides=(("head_dim", "model"), ("act_q_seq", "model"),
                        ("cache_head_dim", "model")),
)

ARCH = ArchSpec(
    arch_id="smollm-135m", family="lm", model=MODEL, shapes=LM_SHAPES,
    source="hf:HuggingFaceTB/SmolLM-135M", optimizer="adam",
    skipped_shapes=(
        ("long_500k",
         "pure full-attention arch; long_500k runs only for "
         "sub-quadratic/hybrid attention per assignment"),
    ),
)
