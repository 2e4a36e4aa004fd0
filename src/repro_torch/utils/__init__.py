"""Small helpers of the port (the scan that the models' chunk loops use)."""
