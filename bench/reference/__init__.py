"""The plain float32 reference of the benchmark's dense decoders: forward
logits (:mod:`.decoder`) and the training step (:mod:`.train`).  Imports
nothing but torch."""
