"""A configuration file and a cell's ``model`` settings as the program's
config."""

from __future__ import annotations

#: switches that would take a hand-written kernel off the timed path:
#: the benchmark always runs #1/#2 (flash) and #3 (decode)
KERNEL_SWITCHES = ("use_flash", "decode_kernel")


def transformer_config(cfg: dict, settings: dict):
    """The program's ``TransformerConfig`` for a GPT-2 configuration file
    (published key names) and a cell's ``model`` block: further
    ``TransformerConfig`` fields by name, ``compute_dtype`` by its torch
    name. An unknown field raises, as does a kernel switch."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import TransformerConfig

    bad = [k for k in KERNEL_SWITCHES if k in settings]
    if bad:
        raise ValueError(f"a cell may not set {bad}: the benchmark times "
                         "the hand-written kernels")
    kw = dict(settings)
    kw["compute_dtype"] = getattr(torch, kw.get("compute_dtype", "float32"))
    return TransformerConfig(
        vocab_size=cfg["vocab_size"], d_model=cfg["n_embd"],
        n_heads=cfg["n_head"], n_layers=cfg["n_layer"], d_ff=cfg["n_inner"],
        max_len=cfg["n_positions"], use_flash=True, **kw)
