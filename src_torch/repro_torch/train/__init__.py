"""Training-side infrastructure: the npz checkpoint / model-store format
(:mod:`.checkpoint`), the streaming re-solver (:mod:`.streaming`), and
the LM training path: the step factories (:mod:`.steps`) and the loop
(:mod:`.loop`)."""
