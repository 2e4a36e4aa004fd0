"""Training substrate.  Ported so far: the checkpoint directory GC that the
model registry shares, and the heartbeat monitor the serving engine uses."""
