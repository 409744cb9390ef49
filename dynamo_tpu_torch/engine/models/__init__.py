"""Model families of the PyTorch engine: dense llama (``llama.py``) and MLA
(``mla.py``, deepseek_v2 with its MoE block)."""


def family(cfg):
    """The module serving ``cfg``: ``mla`` for a latent-KV model
    (kv_lora_rank > 0), else ``llama``. Both give ``param_shapes``,
    ``init_kv_cache``, ``prefill_forward``, ``decode_forward`` and
    ``ragged_forward`` with the same contracts."""
    if cfg.kv_lora_rank > 0:
        from . import mla
        return mla
    from . import llama
    return llama
