"""Evaluation half of the JAX package's ``train`` package: the losses
(``loss``), the evaluation loops (``loops``) and the reading half of its
checkpoints (``checkpoint``).  Training itself is not ported yet."""
