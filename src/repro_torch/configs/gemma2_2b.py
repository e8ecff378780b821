"""gemma2-2b [arXiv:2408.00118] (the port's copy of
repro.configs.gemma2_2b).

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000.
Local (sliding-window 4096) / global alternating layers, attn logit
softcap 50, final logit softcap 30, post-block norms, GeGLU, (1+w) RMSNorm,
embeddings scaled by sqrt(d). On one H100 it trains (2.614B parameters:
about 31 GB of parameters, gradients and f32 adam state) and serves.
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, TransformerConfig

MODEL = TransformerConfig(
    name="gemma2-2b",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    sliding_window=4096, local_global_alternating=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_norm=True, scale_embed=True, act="gelu",
    rope_theta=10_000.0, tie_embeddings=True, remat="full", scan_block=2,
    # the JAX package's 16-way model axis (inert on one device)
    sharding_overrides=(("head_dim", "model"), ("act_q_seq", "model"),
                        ("cache_head_dim", "model")),
)

ARCH = ArchSpec(
    arch_id="gemma2-2b", family="lm", model=MODEL, shapes=LM_SHAPES,
    source="arXiv:2408.00118", optimizer="adam",
)
