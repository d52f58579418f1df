"""Neural-network core of the port: configs, activations, losses, weight
init, preprocessors, layers (the JAX package's ``nn/``)."""
