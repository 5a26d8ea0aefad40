"""Training-side infrastructure: the npz checkpoint / model-store format
(:mod:`.checkpoint`) and the streaming re-solver (:mod:`.streaming`)."""
