"""qwen2.5-32b [hf:Qwen/Qwen2.5-32B family] (the port's copy of
repro.configs.qwen2_5_32b).

64L d_model=5120 40H (GQA kv=8, head_dim=128) d_ff=27648 vocab=152064,
QKV bias. About 32.8B parameters: its training state is far over one
H100's 80 GB, so its full-width runs wait on distribution (ROADMAP.md
queue 1, item 9); it runs reduced on the CPU.
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, TransformerConfig

MODEL = TransformerConfig(
    name="qwen2.5-32b",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0, tie_embeddings=False,
    act="silu", remat="full", attn_chunk=256,
    # the JAX package's 16-way model axis (inert on one device)
    sharding_overrides=(("head_dim", "model"), ("act_q_seq", "model"),
                        ("cache_head_dim", "model")),
)

ARCH = ArchSpec(
    arch_id="qwen2.5-32b", family="lm", model=MODEL, shapes=LM_SHAPES,
    source="hf:Qwen/Qwen2.5-0.5B (scaled per assignment)", optimizer="adam",
    skipped_shapes=(
        ("long_500k",
         "pure full-attention arch; long_500k runs only for "
         "sub-quadratic/hybrid attention per assignment"),
    ),
)
