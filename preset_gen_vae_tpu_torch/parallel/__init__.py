"""Data parallelism across processes, one process a card
(``parallel/multihost.py``). The JAX package's 2-D tensor-parallel mesh
(``parallel/mesh.py``, ``parallel/sharding_rules.py`` there) has no
counterpart here."""
