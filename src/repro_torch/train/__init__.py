"""Training substrate.  Only the checkpoint directory GC that the model
registry shares is ported so far."""
