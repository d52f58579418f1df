"""Models of the port. ``MultiLayerNetwork`` loads its module on first use,
so importing one model does not load the DL4J-era stack."""


def __getattr__(name):
    if name != "MultiLayerNetwork":
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from deeplearning4j_tpu_torch.models.multilayer import MultiLayerNetwork

    return MultiLayerNetwork
