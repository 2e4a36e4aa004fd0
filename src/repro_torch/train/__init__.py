"""Training substrate: AdamW, the train step, checkpoints (whose staging
GC the model registry shares) and the elastic control plane (heartbeat,
straggler and farm-health monitors, mesh planning)."""
