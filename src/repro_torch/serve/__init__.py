"""LM serving: the slot-batched engine and token sampling."""
