"""Architecture registry: the 10 assigned archs (exact published configs).

Source tags are in each entry's docstring. ``get_config(name)`` returns the
full config; ``get_config(name, reduced=True)`` the smoke-test reduction.
A copy of the reference's ``repro.configs.registry`` (data only).
"""
from __future__ import annotations

from repro_torch.configs.base import (DTypePolicy, EncoderConfig,
                                      MLAConfig, ModelConfig, MoEConfig,
                                      SSMConfig, ShardingPolicy,
                                      VisionConfig)

_BIG = DTypePolicy(param_dtype="bfloat16", compute_dtype="bfloat16",
                   opt_dtype="bfloat16")
_STD = DTypePolicy(param_dtype="float32", compute_dtype="bfloat16",
                   opt_dtype="float32")
_FSDP = ShardingPolicy(fsdp=True)


def chatglm3_6b() -> ModelConfig:
    """[arXiv:2406.12793; hf] 28L d4096 32H GQA kv=2 ff13696 v65024, RoPE-2d."""
    return ModelConfig(name="chatglm3-6b", family="dense", n_layers=28,
                       d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
                       vocab_size=65024, head_dim=128, rope_fraction=0.5,
                       qkv_bias=True, dtype=_STD)


def deepseek_7b() -> ModelConfig:
    """[arXiv:2401.02954; hf] 30L d4096 32H MHA ff11008 v102400, llama arch."""
    return ModelConfig(name="deepseek-7b", family="dense", n_layers=30,
                       d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
                       vocab_size=102400, head_dim=128, dtype=_STD)


def qwen15_4b() -> ModelConfig:
    """[hf:Qwen/Qwen1.5-*; hf] 40L d2560 20H kv=20 ff6912 v151936, QKV bias."""
    return ModelConfig(name="qwen1.5-4b", family="dense", n_layers=40,
                       d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
                       vocab_size=151936, head_dim=128, qkv_bias=True,
                       dtype=_STD)


def phi3_medium_14b() -> ModelConfig:
    """[arXiv:2404.14219] 40L d5120 40H GQA kv=10 ff17920 v100352, SwiGLU."""
    return ModelConfig(name="phi3-medium-14b", family="dense", n_layers=40,
                       d_model=5120, n_heads=40, n_kv_heads=10, d_ff=17920,
                       vocab_size=100352, head_dim=128, dtype=_STD)


def mamba2_2p7b() -> ModelConfig:
    """[arXiv:2405.21060] 64L d2560 attn-free v50280 ssm_state=128 (SSD)."""
    return ModelConfig(name="mamba2-2.7b", family="ssm", n_layers=64,
                       d_model=2560, n_heads=0, n_kv_heads=0, d_ff=0,
                       vocab_size=50280,
                       ssm=SSMConfig(d_state=128, d_conv=4, expand=2,
                                     head_dim=64, chunk_size=256),
                       subquadratic=True, dtype=_STD)


def jamba_1p5_large() -> ModelConfig:
    """[arXiv:2403.19887; hf] 72L d8192 64H GQA kv=8 ff24576 v65536,
    Mamba+attn 1:7 interleave, MoE 16e top-2 (every other layer)."""
    return ModelConfig(name="jamba-1.5-large-398b", family="hybrid",
                       n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
                       d_ff=24576, vocab_size=65536, head_dim=128,
                       hybrid_attn_period=8,
                       ssm=SSMConfig(d_state=128, d_conv=4, expand=2,
                                     head_dim=64, chunk_size=256),
                       moe=MoEConfig(num_experts=16, top_k=2,
                                     d_ff_expert=24576, layout="alternate"),
                       subquadratic=True, dtype=_BIG, sharding=_FSDP)


def whisper_tiny() -> ModelConfig:
    """[arXiv:2212.04356] 4L d384 6H ff1536 v51865 enc-dec, conv stub."""
    return ModelConfig(name="whisper-tiny", family="audio", n_layers=4,
                       d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
                       vocab_size=51865, head_dim=64, act="gelu",
                       encoder=EncoderConfig(n_layers=4, n_frames=1500),
                       rope_fraction=0.0,  # learned positions, no rope
                       dtype=_STD)


def pixtral_12b() -> ModelConfig:
    """[hf:mistralai/Pixtral-12B-2409] 40L d5120 32H GQA kv=8 ff14336
    v131072; ViT frontend stub."""
    return ModelConfig(name="pixtral-12b", family="vlm", n_layers=40,
                       d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
                       vocab_size=131072, head_dim=128,
                       vision=VisionConfig(n_patches=256), dtype=_STD)


def deepseek_v2_lite() -> ModelConfig:
    """[arXiv:2405.04434; hf] 27L d2048 16H ff1408(expert) v102400,
    MLA kv_lora=512, 2 shared + 64 routed top-6, first layer dense."""
    return ModelConfig(name="deepseek-v2-lite-16b", family="moe", n_layers=27,
                       d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
                       vocab_size=102400,
                       mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                                     qk_nope_head_dim=128,
                                     qk_rope_head_dim=64, v_head_dim=128),
                       moe=MoEConfig(num_experts=64, num_shared=2, top_k=6,
                                     d_ff_expert=1408, d_ff_shared=2816,
                                     layout="dense_first_k", dense_first_k=1),
                       dtype=_STD)


def deepseek_v3() -> ModelConfig:
    """[arXiv:2412.19437; hf] 61L d7168 128H ff2048(expert) v129280,
    MLA (q_lora 1536), 1 shared + 256 routed top-8, 3 dense first, MTP."""
    return ModelConfig(name="deepseek-v3-671b", family="moe", n_layers=61,
                       d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
                       vocab_size=129280,
                       mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                                     qk_nope_head_dim=128,
                                     qk_rope_head_dim=64, v_head_dim=128),
                       moe=MoEConfig(num_experts=256, num_shared=1, top_k=8,
                                     d_ff_expert=2048, d_ff_shared=2048,
                                     layout="dense_first_k", dense_first_k=3),
                       mtp=True, dtype=_BIG, sharding=_FSDP)


ARCHS = {
    "chatglm3-6b": chatglm3_6b,
    "deepseek-7b": deepseek_7b,
    "qwen1.5-4b": qwen15_4b,
    "phi3-medium-14b": phi3_medium_14b,
    "mamba2-2.7b": mamba2_2p7b,
    "jamba-1.5-large-398b": jamba_1p5_large,
    "whisper-tiny": whisper_tiny,
    "pixtral-12b": pixtral_12b,
    "deepseek-v2-lite-16b": deepseek_v2_lite,
    "deepseek-v3-671b": deepseek_v3,
}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    cfg = ARCHS[name]()
    return cfg.reduced() if reduced else cfg
