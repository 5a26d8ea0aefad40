"""Training-side infrastructure: the npz checkpoint / model-store format."""
