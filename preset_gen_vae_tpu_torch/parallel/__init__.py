"""Parallelism across processes, one process a card: data parallelism
(``parallel/multihost.py``) on the (data, model) grid of tensor
parallelism (``parallel/sharding_rules.py``). The JAX package's 1-D mesh
(``parallel/mesh.py`` there) is the one-process-a-card data parallelism
itself, and has no module of its own here."""
