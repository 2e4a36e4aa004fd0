"""The LM stack of the port: layers, the decoder stack over every block
kind (attention, MoE, RG-LRU, RWKV-6, the frontend stubs), the serving
cache and the model API."""
