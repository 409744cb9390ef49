"""Model + engine configuration for the PyTorch/CUDA engine.

A copy of ``dynamo_tpu.engine.config``'s model side (``ModelConfig`` with
every rope-scaling field, ``from_hf_config``, ``bench_model_config``) so the
two packages parse the same config.json into the same geometry. The engine
side (``EngineConfig``) keeps only the fields the serving paths of this
package read: weight and KV quantization, ragged dispatch,
sequence-parallel prefill, chunked prefill, the dispatch modes
(K-step decode, the pipelined harvest, lane prefill, the deferred
admission fetch) and speculative decoding included; a field of a path
this package does not implement yet (tp/dp/ep/pp, KV tiers) is not a
field, so passing it raises ``TypeError``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class RopeScaling:
    """Rope scaling (config.json `rope_scaling`): llama3-style fields
    plus the yarn fields deepseek checkpoints carry (the JAX package's
    models/mla.py rope_params)."""

    rope_type: str = "default"
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    # yarn (deepseek_v2): 0.0 = absent (HF infers attention scaling
    # from `factor` alone then). attention_factor, when set, OVERRIDES
    # the mscale inference (HF priority order).
    mscale: float = 0.0
    mscale_all_dim: float = 0.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    attention_factor: float = 0.0
    # longrope (phi3 128k variants): per-dim frequency divisors, one per
    # head_dim/2 lane pair. HF switches short→long per forward when
    # seq_len exceeds original_max; a paged serving engine caches K
    # post-rope and cannot re-rope on crossing, so selection is STATIC:
    # "auto" = long iff max_position_embeddings > original_max (the
    # 128k deployment), "short" = the engine proved every servable
    # sequence fits the pretrained window (EngineCore downgrades when
    # max_model_len <= original_max — HF-exact for every request it can
    # serve). The sqrt(1 + ln(M/O)/ln(O)) attention factor multiplies
    # cos/sin in BOTH modes, exactly as HF's fixed attention_scaling.
    short_factor: tuple = ()
    long_factor: tuple = ()
    longrope_active: str = "auto"


def _rope_type(raw_rs: Dict[str, Any]) -> str:
    """Normalized rope type of a raw rope_scaling dict — THE one home
    for the key fallback ("rope_type" | legacy "type") and the
    "su"→"longrope" aliasing (early Phi-3 configs)."""
    rt = raw_rs.get("rope_type", raw_rs.get("type", "default"))
    return "longrope" if rt == "su" else rt


# the model types whose HF config class ties the LM head to the embedding
# when config.json leaves tie_word_embeddings out
TIED_BY_DEFAULT = ("gemma", "gemma2")


@dataclasses.dataclass
class ModelConfig:
    """Transformer shape config (llama / qwen / mixtral families)."""

    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    # MoE (mixtral-style); num_experts == 0 → dense MLP
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # routing-weight convention: True = softmax renormalized over the
    # top-k (mixtral, qwen3_moe); False = softmax over ALL experts with
    # the top-k weights used as-is (qwen2_moe norm_topk_prob=false)
    moe_norm_topk: bool = True
    # qwen2_moe shared expert: a dense swiglu MLP of this intermediate
    # size added to every token, scaled by a learned sigmoid gate
    shared_expert_size: int = 0
    # qwen3-style per-head q/k norm
    qk_norm: bool = False
    # MLA (deepseek_v2): latent-KV attention dims; kv_lora_rank > 0 selects
    # models/mla.py (bf16 or f32 weights, bf16 or int8 latent pools; the
    # engine refuses int8 / int4 weights and sp > 1 with it).
    # q_lora_rank 0 = plain q_proj (the -Lite layout).
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # deepseek MoE deltas (JAX models/mla.py): the first k layers are DENSE
    # with their own intermediate size; routed weights scale by
    # routed_scaling; group-limited routing masks scores to the
    # topk_group best of n_group expert groups before the top-k.
    # moe_routing picks the scoring function: "softmax" (deepseek_v2
    # greedy / group_limited_greedy) or "sigmoid_noaux" (deepseek_v3
    # noaux_tc: sigmoid scores + e_score_correction_bias group choice)
    moe_routing: str = "softmax"
    # deepseek_v3 multi-token-prediction heads: checkpoints carry this
    # many EXTRA layer indices at model.layers.{num_layers}+ that
    # generation never runs — the loader skips exactly that many and
    # still fails loudly on any further excess layer
    num_nextn_predict_layers: int = 0
    first_k_dense: int = 0
    dense_intermediate_size: int = 0
    routed_scaling: float = 1.0
    n_group: int = 0
    topk_group: int = 0
    # gemma-family deltas (model_type gemma/gemma2): gelu MLP, scaled
    # embeddings, (1+w) RMSNorm, post-block norms, logit soft-capping
    hidden_act: str = "silu"          # silu | gelu_pytorch_tanh
    embed_scale: bool = False         # multiply embeddings by sqrt(hidden)
    norm_plus_one: bool = False       # RMSNorm uses (1 + weight)
    post_norms: bool = False          # gemma2 post-attn/post-ffw norms
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None  # None → head_dim
    # gemma2 interleaves sliding-window (local) and global attention
    # layers; which layers are local comes from HF ``layer_types`` (or the
    # even-layers-local default)
    sliding_window: Optional[int] = None
    layer_types: Optional[List[str]] = None

    @classmethod
    def from_hf_config(cls, cfg: Dict[str, Any]) -> "ModelConfig":
        mt = str(cfg.get("model_type", "llama"))
        if mt.startswith("gemma") and mt not in ("gemma", "gemma2"):
            # gemma3+ has different norms/attention — half-detecting it
            # via the gemma defaults would load garbage silently
            raise ValueError(f"unsupported gemma variant {mt!r} "
                             "(gemma and gemma2 are implemented)")
        if mt != "qwen2_moe" and cfg.get("shared_expert_intermediate_size"):
            # an UNKNOWN family carrying a shared expert: the generic
            # expert-name matching would load the routed experts and
            # silently DROP the shared one — garbage logits, no error
            raise ValueError(
                f"unsupported shared-expert MoE family {mt!r} "
                f"(qwen2_moe is the implemented shared-expert family)")
        if mt == "deepseek_v3":
            # JAX models/mla.py implements exactly HF DeepseekV3's semantics:
            # sigmoid-scored noaux_tc routing, interleaved rope, bf16
            # weights — anything else must reject, not half-apply
            if str(cfg.get("scoring_func", "sigmoid")) != "sigmoid":
                raise ValueError(
                    f"deepseek_v3 scoring_func "
                    f"{cfg.get('scoring_func')!r} is not implemented "
                    f"(sigmoid is the v3 routing the reference carries)")
            tm3 = cfg.get("topk_method", "noaux_tc")
            if tm3 != "noaux_tc":
                raise ValueError(
                    f"deepseek_v3 topk_method {tm3!r} is not implemented "
                    f"(noaux_tc is)")
            if cfg.get("rope_interleave") is False:
                # HF default is True (the released-checkpoint layout);
                # half-split rope on interleaved weights decodes garbage
                raise ValueError(
                    "deepseek_v3 rope_interleave=false is not "
                    "implemented (the interleaved rotation is)")
            if cfg.get("quantization_config"):
                raise ValueError(
                    "deepseek_v3 fp8 block-quantized checkpoints "
                    "(quantization_config) are not implemented — load a "
                    "bf16 conversion (engine-side int8/int4 weight "
                    "quantization is applied at load, not from fp8)")
        if mt == "deepseek_v2":
            tm = cfg.get("topk_method", "greedy")
            if cfg.get("n_routed_experts") and tm not in (
                    "greedy", "group_limited_greedy"):
                raise ValueError(
                    f"deepseek_v2 topk_method {tm!r} is not implemented "
                    f"(greedy and group_limited_greedy are)")
            if cfg.get("norm_topk_prob"):
                # transformers' native DeepseekV2 gate reads but never
                # APPLIES norm_topk_prob (4.57.6), while the original
                # remote code renorms instead of scaling — the combined
                # semantics are unpinned, so reject rather than guess
                raise ValueError(
                    "deepseek_v2 norm_topk_prob=true is not implemented "
                    "(reference semantics are unpinned; released V2 "
                    "configs use false)")
        if mt == "qwen3_moe" and not cfg.get("norm_topk_prob", False):
            # moe_mlp implements the normalized (mixtral-equivalent)
            # routing convention; softmax-then-topk WITHOUT renorm is a
            # different function and would decode garbage silently. HF's
            # Qwen3MoeConfig DEFAULTS the key to false, so an absent key
            # must reject too (released checkpoints set it true).
            raise ValueError("qwen3_moe requires norm_topk_prob=true "
                             "(routing weights must renormalize over "
                             "the top-k)")
        if mt in ("qwen2_moe", "qwen3_moe") and (
                cfg.get("mlp_only_layers")
                or int(cfg.get("decoder_sparse_step", 1) or 1) > 1):
            # hybrid dense/sparse layer mixes cannot be represented by
            # the uniform stacked expert tensors; failing here beats a
            # misleading "checkpoint missing experts" later
            raise ValueError(f"{mt} hybrid sparsity (mlp_only_layers "
                             "/ decoder_sparse_step > 1) is not supported "
                             "— every layer must be sparse")
        if mt == "phi3" and cfg.get("rope_scaling"):
            # phi3 128k variants: longrope ("su" is the same function's
            # legacy name in early Phi-3 configs). Anything else would
            # half-apply a different rope and decode garbage.
            rrs = cfg["rope_scaling"]
            if _rope_type(rrs) != "longrope":
                raise ValueError(
                    f"phi3 rope_scaling type {_rope_type(rrs)!r} is not "
                    f"implemented (longrope is)")
            d2 = int(cfg.get("head_dim",
                             int(cfg.get("hidden_size", 4096))
                             // int(cfg.get("num_attention_heads", 32))
                             )) // 2
            sf, lf = rrs.get("short_factor"), rrs.get("long_factor")
            if (not sf or not lf or len(sf) != d2 or len(lf) != d2):
                raise ValueError(
                    f"phi3 longrope needs short_factor and long_factor "
                    f"of length head_dim/2 = {d2} (got "
                    f"{len(sf or [])}/{len(lf or [])})")
            if not cfg.get("original_max_position_embeddings"):
                raise ValueError(
                    "phi3 longrope needs top-level "
                    "original_max_position_embeddings (the pretrained "
                    "window the factor switch and attention scaling "
                    "derive from)")
        n_heads = int(cfg.get("num_attention_heads", 32))
        hidden = int(cfg.get("hidden_size", 4096))
        is_ds = mt in ("deepseek_v2", "deepseek_v3")
        # HF save_pretrained omits class-default keys (to_diff_dict), so
        # absent MoE keys must take each FAMILY's class defaults —
        # otherwise a re-saved MoE config silently parses as dense
        n_experts = int(cfg.get("num_local_experts", 0)
                        or cfg.get("n_routed_experts", 0)     # deepseek
                        or cfg.get("num_experts",
                                   {"qwen2_moe": 60, "qwen3_moe": 128,
                                    "mixtral": 8,
                                    # DeepseekV3Config class default —
                                    # every released V3/R1 is MoE
                                    "deepseek_v3": 256}.get(mt, 0)) or 0)
        moe_inter = int(cfg.get("moe_intermediate_size",
                                {"qwen2_moe": 1408, "qwen3_moe": 768,
                                 # DeepseekV2Config class default (1407!)
                                 "deepseek_v2": 1407,
                                 "deepseek_v3": 2048}.get(mt, 0)) or 0)
        rs = None
        raw_rs = cfg.get("rope_scaling")
        if isinstance(raw_rs, dict):
            rs = RopeScaling(
                rope_type=_rope_type(raw_rs),
                factor=float(raw_rs.get("factor", 1.0)),
                low_freq_factor=float(raw_rs.get("low_freq_factor", 1.0)),
                high_freq_factor=float(raw_rs.get("high_freq_factor", 4.0)),
                # phi3 carries original_max at the TOP level, llama3/yarn
                # inside rope_scaling
                original_max_position_embeddings=int(
                    raw_rs.get(
                        "original_max_position_embeddings",
                        cfg.get("original_max_position_embeddings",
                                8192))),
                short_factor=tuple(raw_rs.get("short_factor") or ()),
                long_factor=tuple(raw_rs.get("long_factor") or ()),
                mscale=float(raw_rs.get("mscale", 0.0) or 0.0),
                mscale_all_dim=float(raw_rs.get("mscale_all_dim", 0.0)
                                     or 0.0),
                beta_fast=float(raw_rs.get("beta_fast", 32) or 32),
                beta_slow=float(raw_rs.get("beta_slow", 1) or 1),
                attention_factor=float(
                    raw_rs.get("attention_factor", 0.0) or 0.0),
            )
        return cls(
            model_type=cfg.get("model_type", "llama"),
            vocab_size=int(cfg.get("vocab_size", 32000)),
            hidden_size=hidden,
            # MoE families size the EXPERT mlps by moe_intermediate_size;
            # our stacked expert tensors use intermediate_size for F
            intermediate_size=int(
                moe_inter if (moe_inter and n_experts > 0)
                else cfg.get("intermediate_size", 4 * hidden)),
            num_layers=int(cfg.get("num_hidden_layers", 32)),
            num_heads=n_heads,
            num_kv_heads=int(cfg.get("num_key_value_heads", n_heads)),
            head_dim=int(cfg.get("head_dim", hidden // n_heads)),
            max_position_embeddings=int(cfg.get("max_position_embeddings", 4096)),
            rms_norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
            rope_theta=float(cfg.get("rope_theta", 10000.0)),
            rope_scaling=rs,
            # an absent key takes HF's default for the family: its Gemma
            # and Gemma2 configs tie, the others do not (the google/
            # gemma-2-9b hub file leaves the key out)
            tie_word_embeddings=bool(cfg.get(
                "tie_word_embeddings", mt in TIED_BY_DEFAULT)),
            # HF Qwen2/Qwen2Moe hardcode qkv bias in the modeling code and
            # ship no attention_bias key, so default it on for them
            attention_bias=bool(cfg.get(
                "attention_bias",
                cfg.get("model_type") in ("qwen2", "qwen2_moe"))),
            num_experts=n_experts,
            # HF save_pretrained omits default-valued keys (use_diff), so
            # each family's OWN default must apply when the key is absent:
            # Mixtral 2, Qwen2Moe 4, Qwen3Moe 8
            num_experts_per_tok=int(cfg.get(
                "num_experts_per_tok",
                {"qwen2_moe": 4, "qwen3_moe": 8,
                 "deepseek_v3": 8}.get(mt, 2))),
            # qwen2_moe DEFAULTS norm_topk_prob=false (weights are the
            # all-expert softmax values, not renormalized); deepseek_v2
            # never renormalizes; deepseek_v3 defaults TRUE (HF
            # DeepseekV3TopkRouter applies it for real); every other
            # family renormalizes over the top-k
            moe_norm_topk=(bool(cfg.get("norm_topk_prob", False))
                           if mt == "qwen2_moe"
                           else False if mt == "deepseek_v2"
                           else bool(cfg.get("norm_topk_prob", True))
                           if mt == "deepseek_v3" else True),
            # the qwen2_moe architecture ALWAYS has a shared expert (HF
            # modeling code is unconditional); an absent key means the
            # HF-default size 5632, NOT "no shared expert" — silently
            # dropping it would be the garbage-logits hazard the
            # unknown-family guard above rejects
            shared_expert_size=int(
                # deepseek: n_shared_experts × the expert width,
                # additive; the ABSENT key means the class default (2
                # for v2, 1 for v3 — to_diff_dict omits defaults), NOT
                # "no shared experts"
                int(cfg.get("n_shared_experts",
                            2 if mt == "deepseek_v2" else 1) or 0)
                * moe_inter
                if is_ds else
                cfg.get("shared_expert_intermediate_size",
                        5632 if mt == "qwen2_moe" else 0) or 0),
            qk_norm=bool(cfg.get("qk_norm", cfg.get("model_type")
                         in ("qwen3", "qwen3_moe"))),
            # hidden_activation is authoritative when present; gemma-1 hub
            # configs ship a stale hidden_act="gelu" that HF itself
            # overrides to the tanh-approx gelu at runtime
            hidden_act=(cfg.get("hidden_activation")
                        or ("gelu_pytorch_tanh"
                            if str(cfg.get("model_type", "")).startswith(
                                "gemma")
                            else cfg.get("hidden_act") or "silu")),
            embed_scale=str(cfg.get("model_type", "")).startswith("gemma"),
            norm_plus_one=str(cfg.get("model_type", "")).startswith("gemma"),
            post_norms=cfg.get("model_type") == "gemma2",
            attn_logit_softcap=(float(cfg["attn_logit_softcapping"])
                                if cfg.get("attn_logit_softcapping")
                                else None),
            final_logit_softcap=(float(cfg["final_logit_softcapping"])
                                 if cfg.get("final_logit_softcapping")
                                 else None),
            query_pre_attn_scalar=(float(cfg["query_pre_attn_scalar"])
                                   if cfg.get("query_pre_attn_scalar")
                                   else None),
            # the five MLA dims share class defaults across both
            # DeepseekV2Config and DeepseekV3Config (512/1536/64/128/
            # 128) — absent keys in a re-saved config mean THOSE, not
            # "no MLA" (an explicit null q_lora_rank is the -Lite
            # plain-q_proj layout, hence `or 0`)
            moe_routing=("sigmoid_noaux" if mt == "deepseek_v3"
                         else "softmax"),
            num_nextn_predict_layers=int(
                cfg.get("num_nextn_predict_layers", 1) or 0)
            if mt == "deepseek_v3" else 0,
            q_lora_rank=int(cfg.get("q_lora_rank",
                                    1536 if is_ds else 0) or 0),
            kv_lora_rank=int(cfg.get("kv_lora_rank", 512) or 0)
            if is_ds else 0,
            qk_nope_head_dim=int(cfg.get(
                "qk_nope_head_dim", 128 if is_ds else 0) or 0),
            qk_rope_head_dim=int(cfg.get(
                "qk_rope_head_dim", 64 if is_ds else 0) or 0),
            v_head_dim=int(cfg.get("v_head_dim",
                                   128 if is_ds else 0) or 0),
            first_k_dense=int(cfg.get(
                "first_k_dense_replace",
                3 if mt == "deepseek_v3" else 0) or 0)
            if n_experts > 0 else 0,
            dense_intermediate_size=int(
                cfg.get("intermediate_size",
                        18432 if mt == "deepseek_v3" else 0) or 0)
            if is_ds and n_experts > 0 else 0,
            routed_scaling=float(
                cfg.get("routed_scaling_factor",
                        2.5 if mt == "deepseek_v3" else 1.0) or 1.0),
            n_group=int(cfg.get("n_group") or 0)
            if cfg.get("topk_method") == "group_limited_greedy"
            else int(cfg.get("n_group", 8) or 0)
            if mt == "deepseek_v3" else 0,
            topk_group=int(cfg.get("topk_group") or 0)
            if cfg.get("topk_method") == "group_limited_greedy"
            else int(cfg.get("topk_group", 4) or 0)
            if mt == "deepseek_v3" else 0,
            sliding_window=(int(cfg.get("sliding_window") or 4096)
                            if mt == "gemma2"
                            else int(cfg["sliding_window"])
                            if mt == "phi3" and cfg.get("sliding_window")
                            else None),
            # phi3 windows EVERY layer (HF Phi3Attention), unlike
            # gemma2's interleave — synthesize explicit layer_types so
            # sliding_layer_mask can't fall back to the gemma2 default
            layer_types=(cfg.get("layer_types")
                         or (["sliding_attention"]
                             * int(cfg.get("num_hidden_layers", 32))
                             if mt == "phi3" and cfg.get("sliding_window")
                             else None)),
        )

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "ModelConfig":
        with open(os.path.join(model_dir, "config.json")) as f:
            return cls.from_hf_config(json.load(f))


def bench_model_config(name: str) -> "ModelConfig":
    """The benchmark geometries, in ONE place so bench.py and
    tools/decode_profile.py measure the same model (they drifted when
    each carried its own literals). Unknown names raise — a typo must
    not silently profile the 1B fallback under the requested label."""
    if name == "tiny":
        return ModelConfig(vocab_size=2048, hidden_size=256,
                           intermediate_size=512, num_layers=4,
                           num_heads=8, num_kv_heads=4, head_dim=32,
                           max_position_embeddings=2048)
    if name == "1b":     # llama-3.2-1B shapes
        # 8192 positions (not the model's real 131k): the shared bench
        # geometry must cover tools/decode_profile.py's long-context
        # sweeps (PROF_SEQ up to ~8K) — 4096 silently capped them once
        # (ADVICE r3). RoPE-table cost at 8192 is negligible.
        return ModelConfig(vocab_size=128256, hidden_size=2048,
                           intermediate_size=8192, num_layers=16,
                           num_heads=32, num_kv_heads=8, head_dim=64,
                           max_position_embeddings=8192,
                           rope_theta=500000.0, tie_word_embeddings=True)
    if name == "8b":     # Llama-3-8B geometry (int8 ≈ 8 GB)
        return ModelConfig(vocab_size=128256, hidden_size=4096,
                           intermediate_size=14336, num_layers=32,
                           num_heads=32, num_kv_heads=8, head_dim=128,
                           max_position_embeddings=8192,
                           rope_theta=500000.0)
    if name == "70b_tp8shard":
        # The slice of Llama-3-70B (80L, D=8192, F=28672, H=64, KVH=8,
        # Dh=128, V=128256) that ONE chip owns under the production TP-8
        # pspecs (parallel/sharding.py param_pspecs: column-parallel
        # qkv/gate/up, row-parallel o/down, vocab-sharded embed+head):
        # 8 q heads, 1 kv head, F/8=3584, V/8=16032, full hidden — ≈8.9 GB
        # int8, the real per-chip HBM working set of the BASELINE.md
        # config-4 north star. Benching this geometry on the one real chip
        # measures the per-chip compute+HBM side of TP-8 decode; the
        # per-layer ICI collectives are priced separately
        # (parallel/ici_model.py) and bench.py reports the net number.
        return ModelConfig(vocab_size=16032, hidden_size=8192,
                           intermediate_size=3584, num_layers=80,
                           num_heads=8, num_kv_heads=1, head_dim=128,
                           max_position_embeddings=8192,
                           rope_theta=500000.0)
    if name == "moe":    # synthetic mixtral-class, one-chip (~4.7 GB)
        return ModelConfig(model_type="mixtral", vocab_size=32000,
                           hidden_size=2048, intermediate_size=5632,
                           num_layers=16, num_heads=32, num_kv_heads=8,
                           head_dim=64, max_position_embeddings=8192,
                           rope_theta=500000.0, num_experts=8,
                           num_experts_per_tok=2)
    if name == "qwen2moe":
        # qwen2_moe-class, one-chip (~3.1 GB int8): Qwen1.5-MoE-A2.7B's
        # D/L/heads/expert-F/shared-F with the expert COUNT cut 60 → 8
        # to fit (the shared-expert + unnormalized-routing code paths are
        # what this geometry times; expert count only scales the einsum)
        return ModelConfig(model_type="qwen2_moe", vocab_size=151936,
                           hidden_size=2048, intermediate_size=1408,
                           num_layers=24, num_heads=16, num_kv_heads=16,
                           head_dim=128, max_position_embeddings=8192,
                           attention_bias=True, num_experts=8,
                           num_experts_per_tok=4, moe_norm_topk=False,
                           shared_expert_size=5632)
    if name == "tiny_mla":
        # CI-sized MLA geometry: exercises the bench's MLA path (latent
        # {"kv"} pool, absorbed-decode flop accounting, hybrid MoE)
        # without the real weights (tests/test_bench_smoke.py)
        return ModelConfig(model_type="deepseek_v2", vocab_size=2048,
                           hidden_size=256, intermediate_size=128,
                           num_layers=4, num_heads=8, num_kv_heads=8,
                           head_dim=48, max_position_embeddings=2048,
                           q_lora_rank=0, kv_lora_rank=64,
                           qk_nope_head_dim=32, qk_rope_head_dim=16,
                           v_head_dim=32, num_experts=4,
                           num_experts_per_tok=2, moe_norm_topk=False,
                           first_k_dense=1, dense_intermediate_size=256,
                           shared_expert_size=256)
    if name == "mla":
        # DeepSeek-V2-Lite-class MLA geometry, one-chip (~3.3 GB int8):
        # Lite's D/L/heads/MLA dims/expert-F/shared/hybrid layout with
        # the expert COUNT cut 64 → 8 to fit (the qwen2moe precedent:
        # expert count only scales the dense-over-E einsum). What this
        # geometry times is the MLA serving win — the absorbed decode
        # reads ONE 576-lane latent row per token instead of
        # KVH·Dh·2 expanded lanes — plus the deepseek MoE block.
        return ModelConfig(model_type="deepseek_v2", vocab_size=102400,
                           hidden_size=2048, intermediate_size=1408,
                           num_layers=27, num_heads=16, num_kv_heads=16,
                           head_dim=192, max_position_embeddings=8192,
                           rope_theta=10000.0,
                           q_lora_rank=0, kv_lora_rank=512,
                           qk_nope_head_dim=128, qk_rope_head_dim=64,
                           v_head_dim=128, num_experts=8,
                           num_experts_per_tok=6, moe_norm_topk=False,
                           first_k_dense=1, dense_intermediate_size=10944,
                           shared_expert_size=2816)
    raise ValueError(f"unknown bench model {name!r} "
                     f"(tiny|tiny_mla|1b|8b|70b_tp8shard|moe|qwen2moe"
                     f"|mla)")


WEIGHT_QUANTIZATIONS = ("none", "int8", "int8-noembed", "int4", "int4-noembed")
KV_QUANTIZATIONS = ("none", "int8")


@dataclasses.dataclass
class EngineConfig:
    """Serving-engine knobs: whole-prompt bucketed or chunked prefill (or,
    over an sp mesh, sequence-parallel prefill of long cold prompts) and K
    decode steps per dispatch (optionally pipelined, with lane prefill), or
    ragged mixed prefill+decode dispatch; a paged
    KV pool (bf16, or int8 rows with in-row scales) with prefix reuse, a
    host and a disk tier behind it and an idle defrag pass;
    weight-only int8/int4 quantization. Field names and defaults follow
    ``dynamo_tpu.engine.config.EngineConfig``; fields of paths this package
    does not implement are absent, so passing one raises ``TypeError``."""

    max_model_len: int = 2048
    kv_block_size: int = 16           # 0 = auto (auto_kv_block_size)
    num_kv_blocks: int = 512          # device KV pool size (blocks)
    max_num_seqs: int = 8             # decode batch slots
    enable_prefix_reuse: bool = True  # match prompt blocks against the pool
    # host KV tier (llm/kv/offload.py; pinned host memory on the card):
    # finished sequences' full blocks are written back there, and device
    # misses cascade to it; 0 = off
    host_kv_blocks: int = 0
    # persistent disk KV tier (llm/kv/diskstore.py): a capacity-bounded
    # content-addressed block store under kv_disk_dir, fed by host-tier
    # evictions (write-behind) and flushed on stop; acknowledged blocks
    # survive kill -9 and warm-start the next engine on the same dir.
    # Needs both fields and host_kv_blocks > 0
    kv_disk_dir: str = ""
    kv_disk_blocks: int = 0           # disk tier capacity; 0 = off
    # remote (G4) KV tier (llm/kv/remotestore.py, llm/kv/fabric.py): an
    # object store rooted at kv_remote_dir (a directory the fleet shares),
    # fed write-behind by the disk tier's capacity evictions and by
    # prefill-publish workers; any worker on the same root admits its
    # blocks. Peer fetch over the fabric needs no directory (the
    # launcher's --kv-fabric). Needs the disk tier; kv_remote_blocks 0 =
    # no object capacity bound
    kv_remote_dir: str = ""
    kv_remote_blocks: int = 0
    # remote-hit admission (fabric.AdmissionGate): "auto" promotes only
    # when the modeled fetch beats the modeled recompute; "always" /
    # "never" override the model
    kv_remote_admission: str = "auto"
    # JAX's simulated device→host link for the write-back (GB/s). The
    # card's copies are real pinned copies: only 0 (the real link) is
    # accepted
    offload_simulated_gbps: float = 0.0
    prefill_buckets: List[int] = dataclasses.field(
        default_factory=lambda: [128, 256, 512, 1024, 2048])
    prefill_chunk: int = 0            # 0 = whole-prompt prefill
    dtype: str = "bfloat16"
    # KV pool: "none" (the activation dtype) | "int8" (per-token int8 rows
    # with the scale in-row, engine/attention.py quantize_kv_rows)
    kv_quantization: str = "none"
    # weight-only: "none" | "int8" | "int8-noembed" | "int4" |
    # "int4-noembed" (engine/quant.py); "-noembed" keeps the embedding in
    # the load dtype
    quantization: str = "none"
    seed: int = 0
    # ragged dispatch (engine/ragged.py): every engine step packs pending
    # prefill chunks and decode rows into ONE mixed batch served by one
    # forward pass, whose attention is the ragged kernel; admissions ride
    # the batch as prefill lanes (continuous batching is the only code
    # path)
    ragged_dispatch: bool = False
    # token capacity of one ragged dispatch (the [sum(T_i)] row budget).
    # 0 = auto: max_num_seqs + 2*ragged_max_seq_rows. Must cover one row
    # per slot.
    ragged_max_tokens: int = 0
    # per-sequence row budget per dispatch: how much of one prompt a
    # single dispatch may consume — longer prompts stream across
    # consecutive dispatches
    ragged_max_seq_rows: int = 64
    # sequence-parallel (ring attention) prefill over the mesh's sp axis;
    # the mesh itself is EngineCore's argument and must agree
    sp: int = 1
    # shortest cold prefill worth the ring path; shorter prompts take the
    # whole-prompt prefill
    sp_min_prefill_tokens: int = 512
    # decode steps fused into one dispatch (engine/programs.py; one CUDA
    # graph replay on the card): tokens are harvested to the host once per
    # dispatch, so the device->host round trip and the host's launch work
    # are paid once per K tokens. K>1 trades step-granular EOS/cancel
    # reaction (worst case K-1 wasted steps per sequence) for throughput.
    # Ignored under ragged_dispatch.
    decode_steps_per_dispatch: int = 1
    # defer each K-dispatch's harvest one dispatch: the next batch chains
    # off on-device tokens while the previous results copy to the host —
    # steady-state cost max(fetch, compute) instead of fetch+compute.
    # Finish/cancel reaction widens to <=2K-1 steps. Requires K > 1, but
    # under ragged_dispatch, where a pure-decode dispatch's harvest is
    # deferred and the next chains off its device tokens.
    # Note on exactness: under RECOMPUTE PREEMPTION (any dispatch mode,
    # pipelined or not) a stream is bit-exact vs an uncontended run only up
    # to its first preemption point — the re-admission prefill's numerics
    # differ slightly from the decode program's, which can flip a greedy
    # argmax at near-tie logits.
    decode_dispatch_pipeline: bool = False
    # continuous-batching lane prefill: when the engine is ALREADY decoding,
    # an admission whose un-hit prompt suffix is <= this many tokens skips
    # the dedicated prefill and instead rides the decode batch — its
    # prompt tokens are fed as "planned" inputs to the K-step decode
    # program (one per step through its slot) and the transition to
    # sampling happens on device mid-dispatch. Idle engines still use the
    # dedicated prefill (better TTFT: one compute-bound dispatch instead
    # of len(prompt) steps). 0 disables; requires
    # decode_steps_per_dispatch > 1.
    lane_prefill_max_tokens: int = 0
    # defer an admission's first-token fetch: the prefill's sampled token
    # copies to the host asynchronously (on the card into pinned memory
    # behind an event) and the admission completes after the next decode
    # dispatch, so the fetch overlaps decode instead of stalling the
    # engine loop. The slot is held but not decoded (nor counted as a
    # decoding slot by lane admission) until then. Emission order per
    # request is unchanged.
    overlap_admission_fetch: bool = True
    # speculative decoding (engine/spec/): the most draft tokens verified a
    # dispatch; 0 = off. When > 0 the engine builds the verify program
    # (engine/programs.py VerifyProgram: [max_num_seqs, spec_k + 1] query
    # rows flattened through the decode forward, one CUDA graph a sampling
    # variant on the card) and, under ragged_dispatch, the ragged
    # program's row-sampled form, whose spec spans verify beside prefill
    # chunks and decode rows. Acceptance is lockstep token equality
    # against per-position sampling keys, so greedy and seeded streams
    # equal plain decode's. A request picks its own k <= spec_k
    # (nvext.speculation); EngineCore.spec_k_live is the default within
    # [0, spec_k].
    spec_k: int = 0
    # the prompt-lookup drafter: trailing n-gram lengths tried (longest
    # first) and how much history is searched
    spec_ngram_max: int = 4
    spec_ngram_min: int = 1
    spec_window: int = 1024
    # JAX's switch for the coalesced attention DMA path. The port's
    # allocator always packs new blocks into runs and has no such path:
    # only True is accepted
    kv_contig_alloc: bool = True
    # idle defrag: when nothing waits and no dispatch is un-harvested, and
    # the free-run fragmentation (pool.frag_ratio: 1 - largest_run/free)
    # or a resident sequence's exceeds this, the worst-fragmented
    # sequence's own blocks move into a free run on the device
    # (block_copy.move_blocks, in place) and pool.relocate rebinds their
    # hashes. 0 disables; skipped while a replay recorder is attached
    kv_defrag_threshold: float = 0.5
    # the most blocks one defrag pass moves
    kv_defrag_max_blocks: int = 64

    @staticmethod
    def auto_kv_block_size(model_cfg: "ModelConfig",
                           kv_quantization: str = "none") -> int:
        """``kv_block_size=0`` resolves as the JAX package resolves it: 64
        for small-C geometries (KVH*Dh <= 128), 32 for int8 pools, else
        16. The rule comes from TPU DMA and tiling; the CUDA kernels take
        any block size."""
        if model_cfg.num_kv_heads * model_cfg.head_dim <= 128:
            return 64
        return 32 if kv_quantization == "int8" else 16

    def __post_init__(self) -> None:
        if self.kv_block_size < 0:
            raise ValueError("kv_block_size must be >= 0 (0 = auto-select "
                             "at engine bring-up)")
        if self.quantization not in WEIGHT_QUANTIZATIONS:
            raise ValueError(f"unknown quantization {self.quantization!r} "
                             f"({'|'.join(WEIGHT_QUANTIZATIONS)})")
        if self.kv_quantization not in KV_QUANTIZATIONS:
            raise ValueError(f"unknown kv quantization "
                             f"{self.kv_quantization!r} (none|int8)")
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be bfloat16 or float32, "
                             f"got {self.dtype!r}")
        if (self.decode_dispatch_pipeline
                and self.decode_steps_per_dispatch <= 1
                and not self.ragged_dispatch):
            raise ValueError(
                "decode_dispatch_pipeline requires decode_steps_per_dispatch"
                " > 1 (the pipeline defers multi-step harvests) — except "
                "under ragged_dispatch, whose single-step dispatches "
                "pipeline via the chained-sample merge")
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 disables speculation)")
        if self.offload_simulated_gbps != 0.0 or not self.kv_contig_alloc:
            raise ValueError(
                "offload_simulated_gbps and kv_contig_alloc are not ported: "
                "only their defaults (0.0, True) are accepted")
        if not 0.0 <= self.kv_defrag_threshold <= 1.0:
            raise ValueError(
                "kv_defrag_threshold must be in [0, 1] (a frag_ratio "
                "bound; 0 disables the defrag pass)")
        if (self.kv_disk_blocks > 0) != bool(self.kv_disk_dir):
            raise ValueError(
                "the disk KV tier needs BOTH kv_disk_dir and "
                "kv_disk_blocks > 0 (set together, or neither)")
        if self.kv_disk_blocks > 0 and self.host_kv_blocks <= 0:
            raise ValueError(
                "the disk KV tier sits under the host tier (spill feeds "
                "on host evictions) — set host_kv_blocks > 0 too")
        if self.kv_remote_dir and self.kv_disk_blocks <= 0:
            raise ValueError(
                "the remote (G4) object tier sits under the disk tier "
                "(promotion feeds on disk evictions) — set kv_disk_dir/"
                "kv_disk_blocks too")
        if self.kv_remote_blocks > 0 and not self.kv_remote_dir:
            raise ValueError(
                "kv_remote_blocks needs kv_remote_dir (the object-store "
                "root); the peer fabric alone has no local capacity")
        if self.kv_remote_admission not in ("auto", "always", "never"):
            raise ValueError(
                "kv_remote_admission must be auto | always | never")
        if self.ragged_dispatch:
            if self.ragged_max_seq_rows <= 0:
                raise ValueError("ragged_max_seq_rows must be > 0")
            if self.ragged_max_tokens == 0:
                self.ragged_max_tokens = (self.max_num_seqs
                                          + 2 * self.ragged_max_seq_rows)
            if self.ragged_max_tokens < max(self.max_num_seqs + 1,
                                            self.ragged_max_seq_rows):
                raise ValueError(
                    f"ragged_max_tokens={self.ragged_max_tokens} must "
                    f"cover one decode row per slot plus prefill "
                    f"headroom (>= max_num_seqs+1 = "
                    f"{self.max_num_seqs + 1}) and at least one full "
                    f"per-sequence chunk (>= ragged_max_seq_rows = "
                    f"{self.ragged_max_seq_rows})")
            if self.sp > 1:
                raise NotImplementedError(
                    "ragged dispatch with sequence-parallel prefill is "
                    "not implemented (long cold prompts would bypass "
                    "the ragged batch; run one or the other). Ragged "
                    "composes with tp, int8 KV, MLA, sliding windows, "
                    "speculative decoding (spec_k), and "
                    "decode_dispatch_pipeline — see docs/"
                    "ragged_attention.md §composition")
        if self.lane_prefill_max_tokens > 0 \
                and self.decode_steps_per_dispatch <= 1:
            raise ValueError(
                "lane_prefill_max_tokens requires decode_steps_per_dispatch"
                " > 1 (planned tokens feed the multi-step program)")
        self.prefill_buckets = sorted(
            b for b in self.prefill_buckets if b <= self.max_model_len) or [
                self.max_model_len]
        if self.prefill_buckets[-1] < self.max_model_len:
            self.prefill_buckets.append(self.max_model_len)

    @property
    def max_blocks_per_seq(self) -> int:
        return (self.max_model_len + self.kv_block_size - 1) // self.kv_block_size

    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if length <= b:
                return b
        raise ValueError(f"prompt length {length} exceeds max_model_len "
                         f"{self.max_model_len}")
