"""The LM stack of the port, forward only: layers, the decoder stack, the
serving cache and the model API."""
