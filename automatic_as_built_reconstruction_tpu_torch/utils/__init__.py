"""Weight conversion (the JAX package's variables, lineage torch
checkpoints), seeded weights, evaluation and the serving export."""
