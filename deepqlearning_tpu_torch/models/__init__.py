"""Feed-forward Q-networks."""
